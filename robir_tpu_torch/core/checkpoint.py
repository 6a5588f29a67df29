"""Checkpoints in the JAX package's format (counterpart of
``robir_tpu/core/checkpoint.py``), so that either package can read what
the other wrote.

Format: one ``.npz`` per checkpoint holding the tree's leaves under their
``/``-joined paths, plus ``__meta__``: the bytes of a JSON object
``{"step": int, "extra": {...}}``. Written through a ``.tmp`` file and a
rename, so a reader never sees half a file. Leaves come back as numpy
arrays with the dtype they were written in.

The port's trees are nested dicts or ``ParamTree`` modules (the weights
bridge, ``core/params.py``). ``restore_into`` on a ``ParamTree`` copies
the loaded leaves into its parameters in place (same tensors, same device,
so optimizers built over them still hold them); on a dict it returns the
merged dict, as the JAX function does. A partial restore filters the
file's paths with ``keep``; a path of the file that the base tree does not
have raises unless ``ignore_unknown`` is set.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable

import numpy as np
import torch

from .params import ParamTree
from .tree import Params, flatten_with_paths, merge_trees, unflatten_paths

_META_KEY = "__meta__"


def _as_array(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def save(path: str, tree: Params, *, step: int = 0, extra: dict | None = None) -> None:
    """Write ``tree`` (nested dicts or ``ParamTree``s of tensors or arrays)
    to ``path``; None leaves are left out."""
    arrays = {k: _as_array(v) for k, v in flatten_with_paths(tree).items() if v is not None}
    meta = {"step": int(step), "extra": extra or {}}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load(path: str) -> tuple[dict, dict]:
    """(nested dict of numpy arrays, metadata) of the checkpoint at ``path``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode()) if _META_KEY in data else {}
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    return unflatten_paths(flat), meta


def restore_into(base: Params, path: str, keep: Callable[[str], bool] | None = None,
                 ignore_unknown: bool = False) -> tuple[Params, dict]:
    """Partial restore: the leaves of ``path`` whose path passes ``keep``
    replace those of ``base``; every other leaf of ``base`` keeps its value.
    A ``ParamTree`` base is updated in place and returned; a dict base gives
    a new dict. Raises KeyError on a loaded path that ``base`` lacks (unless
    ``ignore_unknown``), ValueError on a leaf whose shape differs."""
    loaded, meta = load(path)
    flat = flatten_with_paths(loaded)
    if keep is not None:
        flat = {k: v for k, v in flat.items() if keep(k)}
    known = flatten_with_paths(base)
    if ignore_unknown:
        flat = {k: v for k, v in flat.items() if k in known}
    merged = merge_trees(base, unflatten_paths(flat))  # raises on unknown paths
    _check_shapes(known, flat)
    if not isinstance(base, ParamTree):
        return merged, meta
    copy_into(base, flat)
    return base, meta


def _check_shapes(known: dict, flat: dict) -> None:
    for k, v in flat.items():
        if tuple(np.shape(known[k])) != v.shape:
            raise ValueError(f"{k}: the checkpoint's {v.shape}, the tree's "
                             f"{tuple(np.shape(known[k]))}")


def copy_into(tree: ParamTree, flat: dict) -> None:
    """Copy each ``{path: array}`` of ``flat`` into the leaf of ``tree`` at
    that path, in place; KeyError on a path ``tree`` lacks, ValueError on a
    shape that differs."""
    known = flatten_with_paths(tree)
    unknown = sorted(set(flat) - set(known))
    if unknown:
        raise KeyError(f"paths not in the tree: {unknown[:5]}")
    _check_shapes(known, flat)
    with torch.no_grad():
        for k, v in flat.items():
            known[k].copy_(torch.from_numpy(np.array(v)))


_STEP_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:06d}.npz")


def latest_path(ckpt_dir: str) -> str | None:
    """The newest ``ckpt_<step>.npz`` in a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(ckpt_dir)) if m]
    return step_path(ckpt_dir, max(steps)) if steps else None
