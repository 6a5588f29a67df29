"""Path filtering of nested parameter dicts (the port's copy of the pure
part of ``robir_tpu/core/tree.py``).

Parameters are nested dicts (or the port's ``ParamTree`` modules);
stage-boundary surgery keeps or drops subtrees by top-level path prefix,
as the reference filters state-dict keys (``training/train_pbr.py:157-203``),
and a partial restore merges a loaded tree into a base one
(``merge_trees``, the reference's ``load_state_dict(strict=False)``).
``tree_size_bytes`` sums a tree's leaves; ``tangent_space`` is the
reference's per-normal tangent frame (``utils/utils.py:20-38``).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from .params import ParamTree

Params = Any

_MAPPINGS = (Mapping, ParamTree)


def flatten_with_paths(tree: Params, sep: str = "/") -> dict:
    """Flatten a nested dict into {'a/b/c': leaf} form."""
    out: dict = {}

    def rec(prefix: str, node: Any) -> None:
        if isinstance(node, _MAPPINGS):
            for k in sorted(node.keys()):
                rec(f"{prefix}{sep}{k}" if prefix else str(k), node[k])
        else:
            out[prefix] = node

    rec("", tree)
    return out


def unflatten_paths(flat: Mapping[str, Any], sep: str = "/") -> dict:
    """Inverse of :func:`flatten_with_paths`."""
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def filter_tree(tree: Params, pred: Callable[[str], bool]) -> dict:
    """Keep only leaves whose path satisfies ``pred``."""
    return unflatten_paths({k: v for k, v in flatten_with_paths(tree).items()
                            if pred(k)})


def _under(path: str, prefixes: tuple[str, ...]) -> bool:
    return any(path == q or path.startswith(q + "/") for q in prefixes)


def keep_prefixes(tree: Params, prefixes: tuple[str, ...]) -> dict:
    """Keep subtrees under the given top-level path prefixes."""
    return filter_tree(tree, lambda p: _under(p, prefixes))


def drop_prefixes(tree: Params, prefixes: tuple[str, ...]) -> dict:
    return filter_tree(tree, lambda p: not _under(p, prefixes))


def merge_trees(base: Params, override: Params) -> dict:
    """Leaves present in ``override`` replace those of ``base``; every other
    leaf keeps its ``base`` value. Raises KeyError on a path of
    ``override`` that ``base`` does not have."""
    flat = flatten_with_paths(base)
    over = flatten_with_paths(override)
    unknown = set(over) - set(flat)
    if unknown:
        raise KeyError(f"override contains paths not in base: {sorted(unknown)[:5]} ...")
    flat.update(over)
    return unflatten_paths(flat)


def tree_size_bytes(tree: Params) -> int:
    """Bytes of every leaf of a nested tree (tensors or numpy arrays)."""
    return sum(int(x.numel() * x.element_size()) if torch.is_tensor(x)
               else int(x.size * x.dtype.itemsize)
               for x in flatten_with_paths(tree).values())


def tangent_space(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An orthonormal tangent frame per normal: n rotated 90 degrees about
    x, crossed with n twice, each normalised with a 1e-4 clamp of its
    length. n [..., 3] -> (b, c), each [..., 3]."""
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
                       dtype=n.dtype, device=n.device)
    a = torch.einsum("ij,...j->...i", rot, n)
    b = torch.linalg.cross(a, n, dim=-1)
    c = torch.linalg.cross(b, n, dim=-1)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-4)
    c = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-4)
    return b, c
