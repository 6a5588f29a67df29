"""The weights bridge: JAX-layout parameter trees <-> the port's parameters.

The JAX package keeps parameters as nested dicts of arrays, e.g.
``{"sdf_network": {"lin0": {"v", "g", "b"}, ...}, "color_network": {...},
"deviation_network": {"variance"}}`` with ``v``/``w`` as ``[in, out]`` and
``g``/``b`` as ``[out]``; a node may hold leaves beside subtrees
(``envmap_material_network`` keeps ``lgtSGs`` and ``specular_reflectance``
beside three autoencoders). The port keeps the same tree and layout as
nested ``ParamTree`` modules with fp32 ``nn.Parameter`` leaves, so both
packages compute the same thing from the same numbers,
``module.parameters()`` feeds the optimizer, and ``to_numpy`` gives the
JAX tree back.

``freeze`` is the port's counterpart of the JAX runners'
``split_params``/``join_params``: the frozen subtrees stay in the tree with
``requires_grad=False``, so autograd builds no graph through them and the
trunk kernels are asked for no backward there.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A node of the parameter tree: leaves (parameters) and subtrees
    (``ParamTree``s) by key, in insertion order, read like a dict."""

    def __init__(self, tree: Mapping[str, Any], device="cpu"):
        super().__init__()
        self._order: list[str] = []
        for k, v in tree.items():
            if isinstance(v, (Mapping, ParamTree)):
                self.add_module(k, ParamTree(v, device))
            else:
                self.register_parameter(k, _leaf(v, device))
            self._order.append(k)

    def __getitem__(self, key: str):
        if key not in self._order:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._order

    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def keys(self):
        return list(self._order)

    def values(self):
        return [self[k] for k in self._order]

    def items(self):
        return [(k, self[k]) for k in self._order]


def from_jax(tree: Mapping[str, Any], device="cpu") -> ParamTree:
    """Nested dict of arrays (numpy, JAX or torch leaves) -> ``ParamTree``
    of fp32 parameters on ``device``."""
    return ParamTree(tree, device)


def _leaf(v, device) -> nn.Parameter:
    t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
    return nn.Parameter(t.to(device=device, dtype=torch.float32).clone())


def to_numpy(tree) -> dict:
    """The port's parameters (or any nested mapping of tensors) -> nested
    dict of float32 numpy arrays, the JAX package's layout."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (Mapping, ParamTree)):
            out[k] = to_numpy(v)
        else:
            out[k] = v.detach().to("cpu", torch.float32).numpy().copy()
    return out


def freeze(tree: ParamTree, trainable: Sequence[str]) -> list[nn.Parameter]:
    """``requires_grad=False`` on every subtree or leaf not named in
    ``trainable`` (top-level keys, or ``/``-joined paths into a subtree,
    e.g. ``envmap_material_network/normal_decoder_layer``); returns the
    trainable parameters, in tree order."""
    heads = {p.split("/", 1)[0] for p in trainable}
    unknown = heads - set(tree.keys())
    if unknown:
        raise KeyError(f"no such subtrees: {sorted(unknown)}")
    out = []
    for k, v in tree.items():
        inner = [p.split("/", 1)[1] for p in trainable if p.startswith(k + "/")]
        if k not in trainable and inner:
            if isinstance(v, nn.Parameter):
                raise KeyError(f"{k} is a leaf, not a subtree: {inner}")
            out += freeze(v, inner)
            continue
        params = [v] if isinstance(v, nn.Parameter) else list(v.parameters())
        for p in params:
            p.requires_grad_(k in trainable)
        if k in trainable:
            out += params
    return out
