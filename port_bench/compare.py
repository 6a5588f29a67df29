"""The comparison that decides ``correct`` for a training cell.

Three numbers, each a gap between the program's reading and the
reference's, the worst over what they cover:
- ``loss``: each of the first steps' losses, relative to the reference's;
- ``loss_step1``: the first step's alone (where the later steps' gaps
  swing from seed to seed, a cell's limits may compare this one in
  ``loss``'s place);
- ``first_grad``: each leaf's norm of the first gradient (the program's
  worked out from Adam's first moment after one step, 0.1 x the
  gradient), against the reference's norm of that leaf or of the median
  leaf, whichever is larger (medians over the leaves the reference's
  gradient reaches: a frozen or unused leaf has none);
- ``change``: each leaf's norm of its change over the first steps, as
  ``first_grad``; leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone and are left out.
Norms are taken in float64.
"""

from __future__ import annotations

import statistics

import torch


def _norms(tree: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _median(values) -> float:
    """The median of the non-zero values (0 where there are none)."""
    live = [v for v in values if v > 0]
    return statistics.median(live) if live else 0.0


def _worst(prog: dict[str, float], ref: dict[str, float]) -> tuple[float, str]:
    floor = _median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in ref}
    if not gaps:
        return 0.0, "no leaf moved"
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def training(program: dict, reference: dict, initial: dict) -> dict:
    """``program`` and ``reference``: ``losses``, ``first_grads``,
    ``params`` (after the steps); ``initial``: the weights both started
    from. Returns ``{number: (value, where)}``."""
    if sorted(program["first_grads"]) != sorted(reference["first_grads"]):
        raise KeyError("the program's leaves are not the reference's")
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(program["losses"], reference["losses"], strict=True)]
    g_ref = _norms(reference["first_grads"])
    grad = _worst(_norms(program["first_grads"]), g_ref)
    floor = 1e-3 * _median(g_ref.values())
    moved = [k for k, g in g_ref.items() if g > 0 and g >= floor]

    def change(params):
        return {k: float((params[k].double() - initial[k].double()).norm()) for k in moved}

    return {"loss": (max(gaps), "steps " + ", ".join(f"{g:.3e}" for g in gaps)),
            "loss_step1": (gaps[0], "step 1"),
            "first_grad": grad,
            "change": _worst(change(program["params"]), change(reference["params"]))}


def first_grads_from_adam(optimizers, names: dict) -> dict:
    """The first gradient of each parameter of ``optimizers`` (one Adam or
    several), from Adam's first moment after one step (``exp_avg`` =
    (1 - beta1) x grad; zero where the step had no gradient for it, so Adam
    kept no state); ``names``: parameter -> its path."""
    if isinstance(optimizers, torch.optim.Optimizer):
        optimizers = [optimizers]
    out = {}
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                out[names[p]] = (state["exp_avg"].detach().clone() / (1 - group["betas"][0])
                                 if "exp_avg" in state else torch.zeros_like(p.detach()))
    return out
