"""The SG envmap fit (counterpart of ``robir_tpu/stages/sg_fit.py``; the
reference's ``envmaps/fit_envmap_with_sg.py``): ``num_sg`` spherical
Gaussians fitted to a lat-long envmap image by Adam (lr 1e-2, optax's
``adam``: ``torch.optim.Adam`` at betas (0.9, 0.999), eps 1e-8) on the image
MSE of ``render/sg.py:compute_envmap``; the lobes start as N(0, 1) with
lambda x100. It writes the ``sg_<N>.npy`` that relighting reads
(``fields/envmap_material.py:load_light``) and the fitted image
``fit_<N>.exr``. Runs on ``cuda`` unless ``device="cpu"`` is passed.

    python -m robir_tpu_torch.cli sgfit --envmap_path ENV.exr [--num_sg 128]
        [--n_iters 100000] [--out_dir D] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..render.sg import compute_envmap
from ..utils.resize import resize_area


@dataclasses.dataclass(frozen=True)
class SGFitConfig:
    num_sg: int = 128
    lr: float = 1e-2
    n_iters: int = 100_000
    H: int = 256
    W: int = 512


def init_lgt_sgs(gen: torch.Generator, num_sg: int) -> torch.Tensor:
    """lobe(3) + lambda(1, x100) + mu(3) ~ randn (fit_envmap_with_sg.py:37-38),
    on the generator's device."""
    sgs = torch.randn((num_sg, 7), generator=gen, device=gen.device)
    sgs[:, 3:4] *= 100.0
    return sgs


def fit_envmap(gt_envmap: np.ndarray, cfg: SGFitConfig = SGFitConfig(), seed: int = 0,
               init: np.ndarray | None = None, log_every: int = 0,
               log_fn: Callable[[int, float], None] | None = None,
               device="cuda") -> tuple[np.ndarray, float]:
    """Fit ``cfg.num_sg`` SGs to ``gt_envmap`` [H, W, >= 3] (area-resized to
    ``cfg.H`` x ``cfg.W`` where it differs) for ``cfg.n_iters`` Adam steps,
    from ``init`` [num_sg, 7] or ``init_lgt_sgs`` of a CPU generator seeded
    ``seed``. Every ``log_every`` steps (0: never) ``log_fn(step, loss)``.
    Returns (SGs [num_sg, 7], the loss of the last step, taken before its
    update), as the JAX function does."""
    device = resolve_device(device)
    gt = gt_envmap
    if gt.shape[:2] != (cfg.H, cfg.W):
        gt = resize_area(gt, (cfg.H, cfg.W))
    gt = torch.as_tensor(np.ascontiguousarray(gt[..., :3], np.float32), device=device)
    sgs = (torch.tensor(np.asarray(init, np.float32)) if init is not None
           else init_lgt_sgs(torch.Generator().manual_seed(seed), cfg.num_sg))
    sgs = sgs.to(device).requires_grad_()
    opt = torch.optim.Adam([sgs], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    loss = torch.tensor(float("inf"))
    for i in range(cfg.n_iters):
        loss = torch.mean((compute_envmap(sgs, cfg.H, cfg.W) - gt) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log_every and i % log_every == 0 and log_fn is not None:
            log_fn(i, float(loss))
    return sgs.detach().cpu().numpy(), float(loss)


def main(argv=None) -> tuple[np.ndarray, list]:
    """The command line of the fit; returns (SGs, the logged (step, loss)
    pairs, the last step's last)."""
    import argparse

    from ..utils.exr import read_exr, write_exr
    parser = argparse.ArgumentParser()
    parser.add_argument("--envmap_path", type=str, required=True)
    parser.add_argument("--num_sg", type=int, default=128)
    parser.add_argument("--n_iters", type=int, default=100_000)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    gt = read_exr(args.envmap_path)
    out_dir = args.out_dir or os.path.splitext(args.envmap_path)[0]
    os.makedirs(out_dir, exist_ok=True)
    cfg = SGFitConfig(num_sg=args.num_sg, n_iters=args.n_iters)
    logged = []

    def log(i, loss):
        logged.append((i, loss))
        print(f"step: {i}, loss: {loss}")

    sgs, loss = fit_envmap(gt, cfg, log_every=100, log_fn=log, device=args.device)
    logged.append((cfg.n_iters - 1, loss))
    np.save(os.path.join(out_dir, f"sg_{args.num_sg}.npy"), sgs)
    with torch.no_grad():
        em = compute_envmap(torch.as_tensor(sgs), cfg.H, cfg.W).numpy()
    write_exr(os.path.join(out_dir, f"fit_{args.num_sg}.exr"), em)
    print(f"final loss: {loss}")
    return sgs, logged


if __name__ == "__main__":
    main()
