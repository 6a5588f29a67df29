"""Path filtering of nested parameter dicts (the port's copy of the pure
part of ``robir_tpu/core/tree.py``).

Parameters are nested dicts (or the port's ``ParamTree`` modules);
stage-boundary surgery keeps or drops subtrees by top-level path prefix,
as the reference filters state-dict keys (``training/train_pbr.py:157-203``),
and a partial restore merges a loaded tree into a base one
(``merge_trees``, the reference's ``load_state_dict(strict=False)``).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

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
