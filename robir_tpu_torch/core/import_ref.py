"""Reference checkpoints into the JAX package's ``.npz`` layout (the port's
own copy of ``robir_tpu/core/import_ref.py``).

The reference writes
- stage-1 tarballs ``{step:06d}.tar``: ``torch.save({'global_step': n,
  'model': NeuSModel.state_dict(), ...})`` (neus/optimization/log.py:75-88);
- stage-2 ``ModelParameters/{epoch|latest}.pth``:
  ``{'model_state_dict': IDRNetwork.state_dict(), 'epoch': n}``, with
  key-filtered checkpoint surgery across stages
  (training/train_pbr.py:122-203).

``convert_state_dict`` maps such a state dict onto the parameter tree both
packages share: a torch ``weight`` [out, in] becomes ``w`` [in, out];
weight-norm pairs ``weight_v`` / ``weight_g`` become ``v`` (transposed) /
``g`` (flattened); ``bias`` becomes ``b``; Sequential stacks of (Linear,
activation) pairs, indexed by 2 in torch, become ``lin{i}``. The files are
written through ``core/checkpoint.py``, so either package reads them.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .tree import flatten_with_paths, merge_trees, unflatten_paths

# Sequential (Linear, activation) stacks: torch child index // 2 -> lin{i},
# under the segment named here (None: the lins sit directly under the
# parent module, as in visibility_network/lin0)
_SEQ2 = {
    "vis_layer": None,                 # VisNetwork.vis_layer
    "brdf_encoder_layer": "encoder",   # SparseAE encoder (inner)
    "brdf_decoder_layer": "decoder",   # SparseAE decoder (inner)
    "lobe_layer": "lobe_layer",        # IndirctIllumNetwork.lobe_layer
    "mlp": "energy",                   # EnergyInt.mlp (gamma.energy)
}

# ModuleLists of plain Linears: the torch child index kept
_SEQ1 = {
    "pts_linears": "pts_lin",      # NeRF background
    "views_linears": "views_lin",
}

_RENAME = {
    "feature_linear": "feature",
    "alpha_linear": "alpha",
    "rgb_linear": "rgb",
}


def _map_key(key: str) -> tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """A torch dotted state-dict key -> (the tree's '/'-joined path, the
    value's transform)."""
    parts = key.split(".")
    # the stage-2 bridge nests the whole stage-1 model:
    # implicit_network.neus_model.sdf_network... -> implicit_network/...
    if parts[:2] == ["implicit_network", "neus_model"]:
        parts = ["implicit_network"] + parts[2:]
    # GammaCorrect nests the adaptive shift: gamma.hdr_shift.adapt_illum
    if len(parts) >= 2 and parts[-2] == "hdr_shift":
        parts = parts[:-2] + parts[-1:]

    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p in _SEQ2 and nxt is not None and nxt.isdigit():
            if _SEQ2[p] is not None:
                out.append(_SEQ2[p])
            out.append(f"lin{int(nxt) // 2}")
            i += 2
            continue
        if p in _SEQ1 and nxt is not None and nxt.isdigit():
            out.append(f"{_SEQ1[p]}{int(nxt)}")
            i += 2
            continue
        out.append(_RENAME.get(p, p))
        i += 1

    leaf = out[-1]
    if leaf in ("weight", "weight_v"):
        out[-1] = "w" if leaf == "weight" else "v"
        return "/".join(out), lambda a: np.ascontiguousarray(a.T)
    if leaf == "weight_g":
        out[-1] = "g"
        return "/".join(out), lambda a: a.reshape(-1)
    if leaf == "bias":
        out[-1] = "b"
    return "/".join(out), lambda a: a  # biases and bare parameters (lgtSGs, variance, ...)


def convert_state_dict(sd: dict) -> dict:
    """A torch state dict (tensors or arrays) -> a nested dict of float32
    numpy arrays."""
    flat = {}
    for k, v in sd.items():
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        path, xform = _map_key(k)
        flat[path] = np.asarray(xform(a), dtype=np.float32)
    return unflatten_paths(flat)


def graft(base: dict, converted: dict, keep: Callable[[str], bool] | None = None,
          ignore_unknown: bool = False) -> dict:
    """``converted`` (its paths passing ``keep``) merged into ``base``, shapes
    checked: paths absent from ``converted`` keep their ``base`` values; a
    path ``base`` lacks raises KeyError unless ``ignore_unknown`` drops it;
    a shape that differs raises ValueError."""
    flat = flatten_with_paths(converted)
    if keep is not None:
        flat = {k: v for k, v in flat.items() if keep(k)}
    base_flat = flatten_with_paths(base)
    unknown = [k for k in flat if k not in base_flat]
    if unknown and not ignore_unknown:
        raise KeyError(f"imported paths not in the target tree: "
                       f"{sorted(unknown)[:8]}{'…' if len(unknown) > 8 else ''}"
                       f" (pass ignore_unknown=True to drop them)")
    flat = {k: v for k, v in flat.items() if k in base_flat}
    bad = [(k, tuple(base_flat[k].shape), v.shape) for k, v in flat.items()
           if tuple(base_flat[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"shape mismatches importing reference weights: {bad[:5]}")
    return merge_trees(base, unflatten_paths(flat))


def load_stage1_tar(path: str) -> tuple[dict, int]:
    """``{step:06d}.tar`` -> (the stage-1 NeuS tree, global_step). Only the
    model is imported: the optimizer starts afresh, as after stage-2
    surgery."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in state:
        raise KeyError(f"{path}: no 'model' state dict (keys: {sorted(state)[:6]})")
    return convert_state_dict(state["model"]), int(state.get("global_step", 0))


def load_stage2_pth(path: str) -> tuple[dict, int]:
    """``ModelParameters/*.pth`` -> (the stage-2 tree, epoch)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(state.get("model_state_dict", state)), int(state.get("epoch", 0))


# the reference's cross-stage key filters (training/train_pbr.py:122-203), by name
FILTERS = {
    "all": None,
    # PBR resume: drop the cluster and spec-BRDF heads (train_pbr.py:123-126)
    "pbr_resume": lambda p: "cluster" not in p and "spec_brdf" not in p,
    # Norm surgery: keep only the normal decoder (train_pbr.py:157-159)
    "norm_only": lambda p: "normal_decoder_layer" in p,
    # Vis surgery: the indirect and visibility nets (train_pbr.py:195-203)
    "illum": lambda p: (p.startswith("indirect_illum_network")
                        or p.startswith("visibility_network")),
}


def import_stage1(tar_path: str, out_dir: str) -> str:
    """A reference stage-1 tar -> ``out_dir/ckpt_<step>.npz`` (the
    ``<log_dir>/NeuS`` layout the stage-2 commands read); returns its path."""
    from . import checkpoint as ckpt_lib

    tree, step = load_stage1_tar(tar_path)
    path = ckpt_lib.step_path(out_dir, step)
    ckpt_lib.save(path, {"params": tree}, step=step,
                  extra={"imported_from": os.path.abspath(tar_path)})
    return path


def import_stage2(pth_path: str, base_params: dict, out_path: str, filter_name: str = "all",
                  ignore_unknown: bool = False) -> str:
    """A reference stage-2 pth -> a stage-2 checkpoint at ``out_path``,
    grafted onto ``base_params`` through ``FILTERS[filter_name]`` (subtrees
    it does not hold, such as the energy net, keep ``base_params``'s
    values); returns ``out_path``."""
    from . import checkpoint as ckpt_lib

    tree, epoch = load_stage2_pth(pth_path)
    params = graft(base_params, tree, keep=FILTERS[filter_name], ignore_unknown=ignore_unknown)
    ckpt_lib.save(out_path, params, step=epoch,
                  extra={"imported_from": os.path.abspath(pth_path), "filter": filter_name})
    return out_path
