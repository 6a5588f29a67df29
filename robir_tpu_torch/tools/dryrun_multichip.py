"""One full stage-1 train step over N data-parallel ranks at tiny shapes
(the port's counterpart of ``__graft_entry__.dryrun_multichip``): the
render, the loss with its global counts, the one all-reduce of the
gradients and the Adam update, on every rank; then checks that the loss is
finite, that the ranks' parameters are bit-equal, and prints the backend.

    python -m robir_tpu_torch.tools.dryrun_multichip [--ranks 2] [--device cuda|cpu]

``--device cuda`` (the default): N ranks on the node's GPUs (nccl where
each rank has its own, gloo where they share); ``--device cpu``: N gloo
processes on the CPU. Exits non-zero if a rank fails.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.mesh import DATA_AXIS, DataMesh, spawn_ranks

# the JAX dry run's widths (__graft_entry__.py:66-70): a rank's rows 2
SDF_KW = dict(d_out=33, d_hidden=32, n_layers=2, skip_in=(), multires=2)
COLOR_KW = dict(d_feature=32, d_hidden=32, n_layers=1)
RENDER_KW = dict(n_samples=8, n_importance=8, up_sample_steps=2)
ROWS_PER_RANK = 2


def rank_step(mesh: DataMesh) -> dict:
    """One train step of a tiny NeuS on this rank's rows of a seeded batch;
    returns the backend, the metrics and the flat parameters."""
    from ..core.params import to_numpy
    from ..core.tree import flatten_with_paths
    from ..data.synthetic import make_sphere_scene
    from ..fields.neus_model import NeuSConfig
    from ..fields.radiance import RenderingConfig
    from ..fields.sdf import SDFConfig
    from ..render.neus import NeusRenderConfig
    from ..stages.neus_stage import NeusTrainConfig, NeusTrainer

    scene = make_sphere_scene("train", n_train=2, h=8, w=8)
    trainer = NeusTrainer(
        scene, NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW)),
        NeusRenderConfig(**RENDER_KW),
        NeusTrainConfig(batch_size=ROWS_PER_RANK * mesh.world, lr_delay_steps=0),
        mesh=mesh)
    try:
        metrics = trainer.run(1)
    finally:
        trainer.close()
    return {"backend": mesh.backend, "device": str(mesh.device), "metrics": metrics,
            "params": flatten_with_paths(to_numpy(trainer.model.params))}


def dryrun(n_ranks: int, device: str = "cuda") -> dict:
    """``rank_step`` on ``n_ranks`` spawned ranks; raises RuntimeError if a
    rank fails, the loss is not finite or the replicas differ. Returns rank
    0's result."""
    results = spawn_ranks(rank_step, n_ranks, device=device)
    first = results[0]
    if not np.isfinite(first["metrics"]["loss"]):
        raise RuntimeError(f"loss {first['metrics']['loss']} is not finite")
    for r, res in enumerate(results[1:], 1):
        if not all(np.array_equal(res["params"][k], v) for k, v in first["params"].items()):
            raise RuntimeError(f"rank {r}'s parameters differ from rank 0's")
    return first


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = dryrun(args.ranks, args.device)
    print(f"dry run: {args.ranks} ranks on the {DATA_AXIS!r} axis, backend {res['backend']} on {res['device']}, "
          f"loss {res['metrics']['loss']:.6f}, replicas bit-equal")


if __name__ == "__main__":
    main()
