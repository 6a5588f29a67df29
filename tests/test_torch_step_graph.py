"""Stage 1's graphed train step (``stages/step_graph.py``,
``neus_stage.stage1_step_path``, ``graphed_train_step``).

On the CPU: which trainers the graph path takes, and a step fed through
the static-input path (the batch put in fixed buffers, the draws taken
into them before the loss call, the cos-anneal ratio a 0-d tensor; the
loss call then runs eagerly, as there is no graph on the CPU) against the
eager step, bit for bit over three steps: metrics, parameters, Adam's
state and the draws' generator.

On the card (marked ``cuda``; skips without one): three graphed steps
against three eager steps from the same seed and weights, and the
graph's own record (one capture, the ``neus.graph`` span once a replayed
step, no ``neus.sample`` or ``neus.shade`` there). The tolerance there is
not 0: K4 sums dW over blocks with atomics, in an order that changes from
run to run, so two runs' gradients differ by fp32 rounding and Adam's
first updates (about lr x sign(g)) can move an entry whose gradient is
rounding noise by up to 2 x lr a step either way. The losses agree to
1e-5 relative and every parameter to 2 x lr x steps, 99.9% of the entries
to 1e-6.

This file imports no JAX, so that it also runs where there is none:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from robir_tpu_torch.core.mesh import DataMesh
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.neus_model import HashNeuSConfig, NeuSConfig
from robir_tpu_torch.fields.radiance import NeRFBgConfig, RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.fields.vnerf import VNeRFConfig
from robir_tpu_torch.render.mip import MipRenderConfig
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.stages import neus_stage as tstage
from robir_tpu_torch.tools import profiler
from torch_port_helpers import cuda_or_skip

MODEL = NeuSConfig(sdf=SDFConfig(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2),
                   color=RenderingConfig(d_feature=16, d_hidden=32, n_layers=2))
RENDER = NeusRenderConfig(n_samples=16, n_importance=16, up_sample_steps=2)
TRAIN = tstage.NeusTrainConfig(batch_size=64, lr_init=5e-4, lr_delay_steps=0, max_steps=400,
                               anneal_end=50)
STEPS = 3


def bindings(kind: str):
    if kind == "neus":
        return tstage.make_stage1_bindings("neus", "neus", MODEL, RENDER)
    if kind == "background":
        render = dataclasses.replace(RENDER, n_outside=4)
        return tstage.make_stage1_bindings(
            "neus", "neus", dataclasses.replace(MODEL, background=NeRFBgConfig()), render)
    if kind == "hash":
        return tstage.make_stage1_bindings("hash", "neus", HashNeuSConfig(), RENDER)
    return tstage.make_stage1_bindings("vnerf", "mip", VNeRFConfig(), MipRenderConfig())


@pytest.mark.parametrize("device,mesh,kind,want", [
    ("cuda", False, "neus", "graph"),
    ("cpu", False, "neus", "eager"),
    ("cuda", True, "neus", "eager"),
    ("cuda", False, "background", "eager"),
    ("cuda", False, "hash", "eager"),
    ("cuda", False, "mip", "eager"),
])
def test_the_graph_path_is_chosen_by_device_mesh_and_bindings(device, mesh, kind, want):
    """"graph" for NeuS under the NeuS renderer on a CUDA device without a
    mesh; "eager" on the CPU, under a mesh and for the background shell,
    the hash-grid NeuS and the mip renderer."""
    b = bindings(kind)
    render = dataclasses.replace(RENDER, n_outside=4) if kind == "background" else RENDER
    dmesh = DataMesh(0, 2, torch.device(device)) if mesh else None
    assert tstage.stage1_step_path(torch.device(device), dmesh, b, render) == want


def cpu_trainer(scene, render=RENDER, train=TRAIN, static=False):
    tr = tstage.NeusTrainer(scene, MODEL, render, train, seed=3, device="cpu")
    if static:
        tr._path = "graph"  # the static-input path; on the CPU its loss call runs eagerly
    return tr


@pytest.mark.parametrize("setting", ["default", "no_perturb", "clipped"])
def test_static_input_steps_match_eager_steps_bit_for_bit(setting):
    """Three steps through the static-input path equal three eager steps
    bit for bit: every metric, every parameter, Adam's moments and the
    draws' generator after each; with the jitter's draw (default), without
    any draw (perturb 0) and with the global-norm clip."""
    scene = make_sphere_scene("train", n_train=4, h=16, w=16)
    render = dataclasses.replace(RENDER, perturb=0.0) if setting == "no_perturb" else RENDER
    train = dataclasses.replace(TRAIN, grad_max_norm=0.05) if setting == "clipped" else TRAIN
    eager, static = (cpu_trainer(scene, render, train, s) for s in (False, True))
    try:
        for _ in range(STEPS):
            want, got = eager.run(1), static.run(1)
            assert got == want
            for (k, p), q in zip(eager.model.params.named_parameters(),
                                 static.model.params.parameters()):
                assert torch.equal(p, q), k
            assert torch.equal(eager._noise.get_state(), static._noise.get_state())
    finally:
        eager.close()
        static.close()
    assert eager.step_graph is None and static.step_graph is not None
    assert static.step_graph.captures == 0 and static.step_graph.replays == 0
    assert list(static.step_graph.draws.given) == (["t_rand"] if setting != "no_perturb"
                                                    else [])
    es, ss = eager.state(), static.state()
    assert sorted(es) == sorted(ss)
    for k in es:
        np.testing.assert_array_equal(ss[k], es[k], err_msg=k)


def test_throughput_on_the_static_path_leaves_the_trainer_as_it_was():
    """``throughput`` goes through the static-input path too and restores
    the parameters, Adam's state and the generator afterwards."""
    tr = cpu_trainer(make_sphere_scene("train", n_train=4, h=16, w=16), static=True)
    try:
        tr.run(1)
        before, noise = tr.state(), tr._noise.get_state()
        rays_s = tr.throughput(n_steps=2, warmup=1, reps=1)
        after = tr.state()
    finally:
        tr.close()
    assert rays_s > 0
    assert torch.equal(tr._noise.get_state(), noise)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_a_batch_of_another_shape_is_refused():
    """The buffers hold one batch shape: another raises."""
    scene = make_sphere_scene("train", n_train=4, h=16, w=16)
    tr = cpu_trainer(scene, static=True)
    try:
        tr.run(1)
        with pytest.raises(ValueError, match="origins"):
            tr._inputs(scene.sample(np.random.default_rng(0), 32), tr.step)
    finally:
        tr.close()


# -- on the card ------------------------------------------------------------


def card_trainer(eager: bool):
    tr = tstage.NeusTrainer(make_sphere_scene("train", n_train=4, h=16, w=16), MODEL, RENDER,
                            TRAIN, seed=3, device="cuda")
    assert tr._path == "graph"
    if eager:
        tr._path = "eager"
    return tr


@pytest.mark.cuda
def test_graphed_steps_match_eager_steps_on_the_card():
    """Three graphed steps against three eager steps from the same seed
    and weights (the module docstring's tolerance); one capture, three
    replays."""
    cuda_or_skip()
    graphed, eager = card_trainer(False), card_trainer(True)
    try:
        got = [graphed.run(1) for _ in range(STEPS)]
        want = [eager.run(1) for _ in range(STEPS)]
    finally:
        graphed.close()
        eager.close()
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.isfinite(g[k])
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert graphed.step_graph.captures == 1 and graphed.step_graph.replays == STEPS
    assert torch.equal(graphed._noise.get_state(), eager._noise.get_state())
    bound = 2 * TRAIN.lr_init * STEPS
    for (k, p), q in zip(graphed.model.params.named_parameters(),
                         eager.model.params.parameters()):
        d = (p - q).abs()
        assert float(d.max()) <= bound, k
        assert float((d <= 1e-6).float().mean()) >= 0.999, k


@pytest.mark.cuda
def test_replayed_steps_open_the_graph_span_once_each(tmp_path):
    """Under a profiler, each replayed step opens ``batch``, ``forward``
    holding ``neus.graph``, ``backward`` and ``update`` once, and no
    ``neus.sample`` or ``neus.shade``; one capture in all."""
    cuda_or_skip()
    tr = card_trainer(False)
    try:
        tr.run(1)
        with profiler.trace(str(tmp_path)):
            tr.run(STEPS)
            torch.cuda.synchronize()
    finally:
        tr.close()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fp:
        events = json.load(fp)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    for span in ("batch", "forward", "neus.graph", "backward", "update"):
        assert names.count(span) == STEPS, span
    assert "neus.sample" not in names and "neus.shade" not in names
    assert tr.step_graph.captures == 1 and tr.step_graph.replays == STEPS + 1
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("vg_fwd_kernel" in k for k in kernels)
