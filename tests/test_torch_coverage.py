"""The port does all that the JAX package does, name by name: every public
(no leading ``_``) top-level function and class of every module of
``robir_tpu/`` is defined in the same module of ``robir_tpu_torch/``, or
is listed in ``COUNTERPARTS`` with the port's name that does its work and
why. Both packages are parsed with ``ast``; neither is imported.

The rule for the map: a JAX name whose body is one call of another
function maps to that function, and the port adds no alias. JAX's Pallas
modules (``render/pallas/*``) map to ``render/cuda/*``, whose kernels are
the CUDA sources in ``robir_tpu_torch/csrc/``. The port raises no
``NotImplementedError`` for a piece it has not ported.
"""

import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "robir_tpu", ROOT / "robir_tpu_torch"

# "module:name" of the JAX package -> ("module:name" of the port, why); a
# port name "module:Class.method" is a method of that class
COUNTERPARTS = {
    "core.compact:mesh_shards": (
        "core.mesh:mesh_shards", "the shard count lives beside the port's mesh"),
    "core.mesh:batch_sharding": (
        "core.mesh:local_batch_slice", "one process a rank: a rank holds its slice of the "
        "batch, not a sharding of a global array"),
    "core.mesh:shard_batch": (
        "core.mesh:local_batch_slice", "each rank slices its rows of the global batch"),
    "core.mesh:replicated": (
        "core.mesh:replicate", "replication is a broadcast of rank 0's tensors"),
    "core.tree:to_plain": (
        "stages.neus_stage:NeusTrainer.state", "it serves JAX's checkpoint of optax states; "
        "the trainer writes its Adam moments in optax's layout"),
    "core.tree:from_plain": (
        "stages.neus_stage:NeusTrainer.restore", "it rebuilds optax states from a "
        "checkpoint; the trainer reads the moments back"),
    "fields.sdf:sdf_value": (
        "fields.sdf:sdf_apply", "its body is sdf_apply(out_cols=1)"),
    "fields.sdf:sdf_and_feat": (
        "fields.sdf:sdf_apply", "its body is one sdf_apply call"),
    "fields.sdf:sdf_gradient": (
        "fields.sdf:sdf_full_and_gradient", "the gradient comes with the value from one K3 "
        "call"),
    "fields.sdf:sdf_value_and_gradient": (
        "fields.sdf:sdf_full_and_gradient", "one K3 call gives both"),
    "render.pallas.fused_mlp:MLPPlan": (
        "render.cuda.fused_mlp:MLPPlan", "K1/K2's plan; kernels in csrc/fused_mlp.cu"),
    "render.pallas.fused_mlp:plan_from_sdf_config": (
        "render.cuda.fused_mlp:plan_from_sdf_config", "the plan of an SDF config"),
    "render.pallas.fused_mlp:fold_weight_norm": (
        "fields.sdf:fold_weight_norm", "the field folds its weight norm; the kernel layer "
        "only packs what it is given"),
    "render.pallas.fused_mlp:fused_mlp": (
        "render.cuda.fused_mlp:fused_mlp", "K1 forward, K2 backward (csrc/fused_mlp.cu)"),
    "render.pallas.fused_value_grad:fused_value_grad": (
        "render.cuda.fused_value_grad:fused_value_grad", "K3 forward, K4 backward "
        "(csrc/fused_value_grad.cu)"),
    "stages.cesr:make_cesr_step": (
        "stages.cesr:CESRRunner.step", "a step is a runner method, not a jitted closure"),
    "stages.norm:make_norm_step": (
        "stages.norm:NormRunner.step", "a step is a runner method"),
    "stages.pbr:make_pbr_step": (
        "stages.pbr:PBRRunner.step", "a step is a runner method"),
    "stages.pbr:white_loss": (
        "stages.losses:white_loss", "the port keeps every stage-2 loss term in losses.py"),
    "stages.neus_stage:make_train_step": (
        "stages.neus_stage:train_step", "one eager step, no jitted closure to make"),
    "stages.neus_stage:make_eval_render": (
        "stages.neus_stage:eval_render", "one eager chunked render"),
    "stages.neus_stage:hash_neus_render_binding": (
        "stages.neus_stage:neus_render_binding", "the binding takes the model object, so "
        "one binding serves NeuS and the hash NeuS"),
    "stages.sg_fit:make_fit_step": (
        "stages.sg_fit:fit_envmap", "the fit's loop holds its step"),
    "stages.stage2_runner:split_params": (
        "core.tree:keep_prefixes", "its body is keep_prefixes and drop_prefixes; the "
        "runners freeze subtrees of one tree instead (core.params:freeze)"),
    "stages.stage2_runner:join_params": (
        "core.tree:drop_prefixes", "the inverse of split_params, which the port never "
        "splits"),
    "stages.losses:kl_loss": (
        "fields.sparse_ae:ae_kl_divergence", "its body is one ae_kl_divergence call"),
    "tools.profiler:time_scanned": (
        "tools.profiler:time_scanned_reps", "its body is min() of time_scanned_reps, whose "
        "callers keep every run"),
    "tracing.grid:bake_march_layout": (
        "tracing.grid:build_sdf_grid", "the TPU lookup layouts (quad rows, blocked gathers); "
        "the port's march reads the baked grid as it is"),
}


def _module(path: Path, root: Path) -> str:
    return ".".join(path.relative_to(root).with_suffix("").parts)


def _defs(root: Path) -> dict:
    """{module: {top-level name: {method names}}} of a package's sources."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        out[_module(path, root)] = {
            n.name: {m.name for m in n.body if isinstance(m, (ast.FunctionDef,
                                                              ast.AsyncFunctionDef))}
            if isinstance(n, ast.ClassDef) else set()
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}
    return out


def _exists(defs: dict, target: str) -> bool:
    module, name = target.split(":")
    cls, _, method = name.partition(".")
    names = defs.get(module, {})
    return cls in names and (not method or method in names[cls])


def test_every_jax_name_has_a_counterpart():
    jax_defs, port = _defs(JAX), _defs(PORT)
    missing, stale = [], []
    for module, names in jax_defs.items():
        for name in names:
            if name.startswith("_"):
                continue
            key = f"{module}:{name}"
            if name in port.get(module, {}):
                if key in COUNTERPARTS:
                    stale.append(f"{key} is defined in the port; drop its map entry")
            elif key not in COUNTERPARTS:
                missing.append(key)
    assert not missing, f"JAX names with no port counterpart: {missing}"
    assert not stale, stale
    for key, (target, why) in COUNTERPARTS.items():
        assert _exists(jax_defs, key), f"{key} is not a JAX name"
        assert _exists(port, target), f"{key} maps to {target}, which the port lacks"
        assert why and not target.startswith("_")


def test_pallas_modules_map_to_cuda_sources():
    """Each JAX Pallas module has a port launcher module and a CUDA source."""
    for path in sorted((JAX / "render" / "pallas").glob("[!_]*.py")):
        assert (PORT / "render" / "cuda" / path.name).exists(), path.name
        assert (PORT / "csrc" / path.with_suffix(".cu").name).exists(), path.name


def _messages(node: ast.AST) -> str:
    return " ".join(n.value for n in ast.walk(node)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str))


def test_no_refusal_left():
    """No ``raise NotImplementedError(...)`` in the port says that a piece is
    not ported (refusals of a file format the JAX package refuses too stay)."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc.func if isinstance(node.exc, ast.Call) else node.exc
            if getattr(exc, "id", None) == "NotImplementedError" and re.search(
                    r"not\s+(yet\s+)?ported|port\s+lacks", _messages(node.exc), re.I):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not found, found
