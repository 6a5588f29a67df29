"""The weights bridge: JAX-layout parameter trees <-> the port's parameters.

The JAX package keeps parameters as nested dicts of arrays, e.g.
``{"sdf_network": {"lin0": {"v", "g", "b"}, ...}, "color_network": {...},
"deviation_network": {"variance"}}`` with ``v``/``w`` as ``[in, out]`` and
``g``/``b`` as ``[out]``. The port keeps the same tree and layout as nested
``nn.ModuleDict``/``nn.ParameterDict`` of fp32 ``nn.Parameter`` leaves, so
both packages compute the same thing from the same numbers and
``module.parameters()`` feeds the optimizer.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def from_jax(tree: Mapping[str, Any], device="cpu") -> nn.ModuleDict:
    """Nested dict of arrays (numpy, JAX or torch leaves) -> nested
    ``ModuleDict``/``ParameterDict`` of fp32 parameters on ``device``."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    subtrees = {k: v for k, v in tree.items() if isinstance(v, Mapping)}
    if leaves and subtrees:
        raise ValueError(f"mixed leaves and subtrees under {sorted(tree)}")
    if leaves:
        return nn.ParameterDict({k: _leaf(v, device) for k, v in leaves.items()})
    return nn.ModuleDict({k: from_jax(v, device) for k, v in subtrees.items()})


def _leaf(v, device) -> nn.Parameter:
    t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
    return nn.Parameter(t.to(device=device, dtype=torch.float32).clone())


def to_numpy(tree) -> dict:
    """The port's parameters (or any nested mapping of tensors) -> nested
    dict of float32 numpy arrays, the JAX package's layout."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (Mapping, nn.ModuleDict, nn.ParameterDict)):
            out[k] = to_numpy(v)
        else:
            out[k] = v.detach().to("cpu", torch.float32).numpy().copy()
    return out
