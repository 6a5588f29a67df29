"""The PBR and CESR steps' graph path (``stages/material_graph.py``) and the
padded compaction under it (``core/compact.py``).

On the CPU: ``compact_apply_padded`` against ``compact_apply`` at 0, 1,
129 and all of 300 rows needed (chunk 128); which runners take the graph
path; and three or four steps of ``PBRRunner`` and ``CESRRunner`` through
the padded path (the batch in fixed buffers, the draws taken into them, the
render on the padded rows; on the CPU the loss call runs eagerly, as there
is no graph) against the eager step from the same seed: the loss and every
trainable's gradient to 1e-6 relative, Adam's moments, and the draws'
generator bit for bit after each step. CESR runs two warm-up steps and two
explore steps: two keys.

On the card (marked ``cuda``; skips without one): replays of bucket A, B,
A against the eager steps on the same batches and draws (learning rate 0,
so that every step starts from the same weights); one capture a key; the
memory reserved after the second capture within 10% of that after the
first (one pool); and the ``stage2.graph`` span once a replayed step.

This file imports no JAX, so that it also runs where there is none:

    python -m pytest --noconftest tests/test_torch_material_graph.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from robir_tpu_torch.core.compact import (bucket_rows, compact_apply, compact_apply_padded,
                                          pad_rows)
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.mesh import DataMesh
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.envmap_material import EnvmapMaterialConfig
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.visibility import IndirIllumConfig, VisNetConfig
from robir_tpu_torch.render.color import ToneMapConfig
from robir_tpu_torch.render.stage2 import Stage2Config
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages.material_graph import graphable
from robir_tpu_torch.stages.stage2_runner import StageOptConfig
from robir_tpu_torch.tools import profiler
from robir_tpu_torch.tracing import grid as tg
from torch_port_helpers import SHADOW_SPHERES, cuda_or_skip

CHUNK = 128
N_LIGHTS = 8
NET = dict(d_hidden=96, n_layers=3, skip_in=(2,), multires=0)  # 63 + 33 at the skip


def stage2_config(lights: int = N_LIGHTS, vis_dims=(32, 32)) -> Stage2Config:
    return Stage2Config(
        neus=NeuSConfig(sdf=tsdf.SDFConfig(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,),
                                           multires=3),
                        color=RenderingConfig(d_feature=32, d_hidden=32, n_layers=2)),
        envmap=EnvmapMaterialConfig(multires=3, num_lgt_sgs=lights, encoder_dims=(48, 48),
                                    decoder_dims=(24,), latent_dim=8),
        indirect=IndirIllumConfig(multires=3, dims=(32, 32), num_lgt_sgs=6),
        visnet=VisNetConfig(points_multires=3, dirs_multires=3, dims=vis_dims),
        tonemap=ToneMapConfig(hdr_mode=0), tracer="grid",
        grid=tg.GridConfig(resolution=32, max_steps=64, storage_dtype="bfloat16",
                           quad_rows=True))


@dataclasses.dataclass(frozen=True)
class SmallCESR(tcesr.CESRStageConfig):
    @property
    def shadow_cfg(self):
        return tsdf.SDFConfig(d_in=63 + self.num_lights, d_out=2, **NET)

    @property
    def normal_cfg(self):
        return tsdf.SDFConfig(d_in=63, d_out=3, **NET)


def two_sphere_grid(gcfg) -> torch.Tensor:
    """The analytic sdf of the shadow scene's two spheres on the grid's
    nodes, in its storage dtype."""
    R = gcfg.resolution
    axes = [np.linspace(gcfg.bbox_min[i], gcfg.bbox_max[i], R, dtype=np.float32)
            for i in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    sdf = np.min([np.linalg.norm(p - np.float32(c), axis=-1) - np.float32(r)
                  for c, r in SHADOW_SPHERES], axis=0).astype(np.float32)
    grid = torch.as_tensor(sdf)
    return grid.to(torch.bfloat16) if gcfg.storage_dtype == "bfloat16" else grid


def in_fp64(dataset):
    """``dataset`` with its pixel batches' real arrays in float64."""
    sample = dataset.sample_pixels

    def sample64(*args, **kw):
        return {k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in sample(*args, **kw).items()}

    dataset.sample_pixels = sample64
    return dataset


def runner(kind: str, device="cpu", graphed: bool = False, cfg=None, dataset=None,
           dtype=torch.float32, **kw):
    """A PBR or CESR runner on the shadow scene with the analytic grid;
    ``graphed``: the graph path forced on (on the CPU, the padded path
    without a graph); ``dtype`` float64: the parameters and batches in
    float64 (the caller sets the default dtype, which the draws take)."""
    cfg = cfg or stage2_config()
    dataset = dataset or shadow_scene(n_train=3, h=40, w=40)
    if dtype == torch.float64:
        dataset = in_fp64(dataset)
    params = trunner.init_stage2_params(torch.Generator().manual_seed(1), cfg)
    if kind == "pbr":
        r = tpbr.PBRRunner(cfg, params, dataset,
                           tpbr.PBRStageConfig(**{"num_pixels": 320, "compact_chunk": CHUNK,
                                                  **kw}), seed=5, device=device)
    else:
        stage = SmallCESR(**{"num_pixels": 320, "compact_chunk": CHUNK,
                             "num_lights": cfg.envmap.num_lgt_sgs, "warmup_iters": 1,
                             "normal_switch_iter": 2, "dropout_iter": 2, **kw})
        r = tcesr.CESRRunner(cfg, params, dataset, stage, seed=5, device=device)
    r.params.to(dtype)
    r.grid_values = two_sphere_grid(cfg.grid).to(r.device)
    if graphed:
        r._graph_on = True
    return r


# -- padded compaction --------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 129, 300])
def test_padded_compaction_is_compact_apply(k):
    """The padded call's outputs equal ``compact_apply``'s bit for bit, and
    so do the gradients of the inputs and of a weight every row reads; the
    padding rows' gradients are exactly zero."""
    n = 300
    gen = torch.Generator().manual_seed(k)
    need = torch.zeros(n, dtype=torch.bool)
    need[torch.randperm(n, generator=gen)[:k]] = True
    x0 = torch.randn((n, 4), generator=gen, dtype=torch.float64)
    v0 = torch.randn((n,), generator=gen, dtype=torch.float64)
    w0 = torch.randn((4,), generator=gen, dtype=torch.float64)
    cot = torch.randn((n, 4), generator=gen, dtype=torch.float64)
    taken = []

    def run(padded: bool):
        x, v = x0.clone().requires_grad_(), v0.clone().requires_grad_()
        w = w0.clone().requires_grad_()

        def fn(x, v):
            x.retain_grad()
            taken.append(x)
            return {"a": torch.sin(x) * w + v[:, None], "b": v > 0}

        if padded:
            b = bucket_rows(k, CHUNK)
            index = torch.empty(b, dtype=torch.int64)
            valid = torch.empty(b, dtype=torch.bool)
            pad_rows(torch.nonzero(need).squeeze(1), index, valid)
            out = compact_apply_padded(fn, index, valid, [x, v])
        else:
            out = compact_apply(fn, need, [x, v])
        (out["a"] * cot).sum().backward()
        return out, x.grad, v.grad, w.grad

    want, got = run(False), run(True)
    b = bucket_rows(k, CHUNK)
    assert taken[0].shape[0] == max(k, 1) and taken[1].shape[0] == b
    assert b % CHUNK == 0 and b - CHUNK < max(k, 1) <= b
    for key in ("a", "b"):
        assert torch.equal(got[0][key], want[0][key]), key
    for g, e in zip(got[1:], want[1:]):
        assert torch.equal(g, e)
    assert torch.equal(taken[1].grad[k:], torch.zeros_like(taken[1].grad[k:]))


# -- the path each runner takes ------------------------------------------------


@pytest.mark.parametrize("device,mesh,want", [("cuda", False, True), ("cpu", False, False),
                                              ("cuda", True, False)])
def test_the_graph_path_is_chosen_by_device_and_mesh(device, mesh, want):
    dmesh = DataMesh(0, 2, torch.device(device)) if mesh else None
    assert graphable(torch.device(device), dmesh) == want


@pytest.mark.parametrize("chunk,want", [(CHUNK, True), (0, False), (320, False)])
def test_only_compacted_steps_are_graphed(chunk, want):
    """A dense step (chunk 0, or a chunk the batch does not exceed) and a
    step the guard turns dense stay eager."""
    r = runner("pbr", graphed=True, compact_chunk=chunk)
    assert r._graphed(r.step_config()) == want
    r.surface_frac = 0.9  # above compact_max_surface_frac: the guard goes dense
    assert not r._graphed(r.step_config())


# -- padded steps against eager steps on the CPU --------------------------------


def adam_state(r) -> list:
    """Each trainable's Adam state, (step, first, second moment); () for a
    leaf without a gradient yet."""
    return [tuple(s[k] for k in ("step", "exp_avg", "exp_avg_sq") if k in s)
            for s in (r.optimizer.state[p] for p in r.trainable)]


def assert_rel(got, want, what, rel=1e-6):
    """``got`` within ``rel`` of ``want``, relative, by the norm of their
    difference."""
    got, want = got.double(), want.double()
    assert float((got - want).norm()) <= rel * float(want.norm()), what


@pytest.mark.parametrize("kind,dtype,switch", [("pbr", torch.float32, 0),
                                               ("cesr", torch.float64, 10),
                                               ("cesr", torch.float64, 2)],
                         ids=["pbr", "cesr_fp64", "cesr_new_normal_fp64"])
def test_padded_steps_match_eager_steps(kind, dtype, switch):
    """Steps through the padded path against eager steps from the same
    seed, at learning rate 0: the loss, each other metric (to 1e-6 of the
    loss) and every trainable's gradient to 1e-6 relative (by norm), Adam's
    moments likewise, the generator bit for bit; k is not a whole number
    of chunks, so padding rows ran. PBR: three steps in float32. CESR: two
    warm-up steps (no rgb term) and two explore steps, with the latent
    dropout resampled after step 2: two keys; and with the refined normal
    from step 3, a third key. CESR runs in float64, to 1e-12 (its
    readings are 1e-15): in float32 the normal net's gradient, through n /
    |n|, takes the rounding of sums over B rows against k up to 7e-6."""
    # lr 0: every step starts from the same weights. The padded render's
    # sums run over B rows, the eager one's over k, and round apart;
    # Adam's first updates (about lr x sign(g)) would turn that into lr on
    # an entry whose gradient is rounding noise, and the next step's
    # gradients would be of other weights
    kw = {"opt": StageOptConfig(lr=0.0), "dtype": dtype}
    if kind == "cesr":
        kw["normal_switch_iter"] = switch
    rel = 1e-6 if dtype == torch.float32 else 1e-12
    steps = 3 if kind == "pbr" else 4
    torch.set_default_dtype(dtype)
    try:
        eager, padded = runner(kind, **kw), runner(kind, graphed=True, **kw)
        for i in range(steps):
            want, got = eager.run(1), padded.run(1)
            assert sorted(got) == sorted(want)
            assert got["loss"] == pytest.approx(want["loss"], rel=rel, abs=0), i
            for k in want:  # its terms, some of them differences of near values
                assert got[k] == pytest.approx(want[k], rel=rel,
                                               abs=rel * abs(want["loss"])), (i, k)
            for (name, p), q in zip(eager.params.named_parameters(),
                                    padded.params.parameters()):
                if p.requires_grad:
                    assert (p.grad is None) == (q.grad is None), name
                    if p.grad is not None:
                        assert_rel(q.grad, p.grad, (i, name), rel)
                assert torch.equal(q, p), (i, name)
            for a, b in zip(adam_state(padded), adam_state(eager)):
                assert len(a) == len(b), i
                for x, y in zip(a, b):
                    assert_rel(x, y, i, rel)
            assert torch.equal(padded.generator.get_state(), eager.generator.get_state())
    finally:
        torch.set_default_dtype(torch.float32)
    g = padded.graphs
    assert eager.graphs is None and g is not None
    assert g.captures == g.replays == g.eager_fallbacks == 0
    assert g.padded_rows > 0
    if kind == "cesr":
        want = {("warmup", False, False), ("explore", False, True)}
        if switch == 2:
            want.add(("explore", True, True))
        assert {key[1:] for key in g.entries} == want
        assert torch.equal(padded.spec_var, eager.spec_var)
    for key, entry in g.entries.items():
        assert entry.padded == key[0] and key[0] % CHUNK == 0


def test_a_restore_drops_the_graphs(tmp_path):
    """``restore_surgical`` (a checkpoint's leaves in place) drops the
    graph set; the next compacted step makes a new one."""
    r = runner("pbr", graphed=True)
    r.log_dir = str(tmp_path)
    r.run(1)
    assert r.graphs is not None
    path = r.save()
    r.restore_surgical(path, keep=lambda p: p.startswith("gamma"))
    assert r.graphs is None
    r.run(1)
    assert r.graphs is not None and len(r.graphs.entries) == 1


# -- on the card ----------------------------------------------------------------


def card_batches(dataset, on_object: tuple, n: int, seed: int = 3) -> list:
    """Batches of ``n`` pixels of view 0 of which the counts in
    ``on_object`` lie on the object, so that each falls into a bucket of
    its own."""
    rng = np.random.default_rng(seed)
    mask = dataset.object_masks[0].reshape(-1)
    out = []
    for m in on_object:
        idx = np.concatenate([rng.choice(np.flatnonzero(mask), m, replace=False),
                              rng.choice(np.flatnonzero(~mask), n - m, replace=False)])
        b = dataset.pixels(0, idx)
        out.append({k: b[k] for k in trunner.BATCH_KEYS})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pbr", "cesr"])
def test_replayed_buckets_give_the_eager_gradients_on_the_card(kind):
    """Steps of buckets A, B, A (replayed: A's graph again after B's) at
    learning rate 0, against eager steps on the same batches and the same
    generator: the same loss to 1e-5 relative and every gradient relative
    by norm to 1e-5 in PBR, 1e-4 in CESR (K1, K2, K3 and cuBLAS run B rows
    against the eager step's k, so sums round in another order: CESR's
    shadow net read 1.8e-5 on the card) and 1e-3 at its normal net (through
    n / |n| in fp32 the padded step without a graph reads up to 9.8e-5
    against the eager one there); one capture a key, the generator bit for
    bit."""
    cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = {"num_pixels": 256, "compact_chunk": 32, "opt": StageOptConfig(lr=0.0)}
    if kind == "cesr":
        kw.update(warmup_iters=0, normal_switch_iter=0, dropout_iter=0)
    dataset = shadow_scene(n_train=3, h=40, w=40)
    graphed = runner(kind, "cuda", dataset=dataset, **kw)
    eager = runner(kind, "cuda", dataset=dataset, **kw)
    eager._graph_on = False
    if kind == "cesr":  # explore with the refined normal at every step: one flag set
        graphed.cur_iter = eager.cur_iter = 1
    a, b = card_batches(dataset, (150, 40), 256)
    try:
        for batch in (a, b, a):
            want = eager.step(eager._local(batch), Draws(eager.generator, device="cuda"))
            got = graphed.step(dict(batch), None)
            torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-5, atol=0)
            for (name, p), q in zip(eager.params.named_parameters(),
                                    graphed.params.parameters()):
                if p.requires_grad and p.grad is not None:
                    assert_rel(q.grad, p.grad, name,
                               1e-3 if name.startswith("normal_net.")
                               else 1e-4 if kind == "cesr" else 1e-5)
            assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
        g = graphed.graphs
        assert (g.captures, g.replays, g.eager_fallbacks) == (2, 3, 0)
        assert len({key[0] for key in g.entries}) == 2
    finally:
        graphed.close()


@pytest.mark.cuda
def test_the_buckets_share_one_pool_on_the_card(tmp_path):
    """At 16 lights and a 4 x 256 visibility net (the sweep's activations,
    gigabytes at 1,500 rows, dominate), the memory reserved after a second
    capture (a smaller bucket) stays within 10% of that after the first;
    each replayed step opens ``stage2.graph`` once, inside ``forward``."""
    cuda_or_skip()
    cfg = stage2_config(lights=16, vis_dims=(256,) * 4)
    dataset = shadow_scene(n_train=3, h=96, w=96)
    r = runner("pbr", "cuda", cfg=cfg, dataset=dataset, num_pixels=2048)
    big, small = card_batches(dataset, (1500, 400), 2048)
    try:
        r.step(dict(big), None)
        torch.cuda.synchronize()
        first = torch.cuda.memory_reserved()
        r.step(dict(small), None)
        torch.cuda.synchronize()
        second = torch.cuda.memory_reserved()
        assert r.graphs.captures == 2
        assert second <= 1.1 * first, (first, second)
        with profiler.trace(str(tmp_path)):
            for batch in (big, small):
                r.step(dict(batch), None)
            torch.cuda.synchronize()
        assert (r.graphs.captures, r.graphs.replays) == (2, 4)
    finally:
        r.close()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fp:
        events = json.load(fp)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    assert names.count("stage2.graph") == names.count("forward") == 2
    assert "stage2.shade" not in names
