"""The random numbers of a step, by name.

The JAX package draws from PRNG keys split along the call tree; a
``torch.Generator`` cannot give the same numbers. So the port's functions
that draw take the draw itself as a tensor argument, and the stage code
above them asks a ``Draws`` for each one by name: from its generator, or
from ``given`` (the parity tests hand in the draws the JAX code makes from
its keys; ``chip_smoke.py`` replays on the card what the CPU drew).
``record=True`` keeps every draw made, in ``taken``. Draws come in the
default dtype (float32 unless a caller sets another).
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, generator: torch.Generator | None = None,
                 given: dict | None = None, device="cpu",
                 record: bool = False):
        self.generator = generator
        self.given = dict(given or {})
        self.device = torch.device(device)
        self.taken: dict | None = {} if record else None

    def _draw(self, name: str, shape, fn) -> torch.Tensor:
        if name in self.given:
            t = self.given[name].to(self.device, torch.get_default_dtype())
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draw {name!r}: given {tuple(t.shape)}, "
                                 f"needed {tuple(shape)}")
        else:
            if self.generator is None:
                raise KeyError(f"draw {name!r} was not given and there is no generator")
            t = fn(tuple(shape), generator=self.generator, device=self.device)
        if self.taken is not None:
            self.taken[name] = t
        return t

    def uniform(self, name: str, shape) -> torch.Tensor:
        """U[0, 1) of ``shape``."""
        return self._draw(name, shape, torch.rand)

    def normal(self, name: str, shape) -> torch.Tensor:
        """N(0, 1) of ``shape``."""
        return self._draw(name, shape, torch.randn)
