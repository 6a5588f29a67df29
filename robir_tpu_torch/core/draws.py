"""The random numbers of a step, by name.

The JAX package draws from PRNG keys split along the call tree; a
``torch.Generator`` cannot give the same numbers. So the port's functions
that draw take the draw itself as a tensor argument, and the stage code
above them asks a ``Draws`` for each one by name: from its generator, or
from ``given`` (the parity tests hand in the draws the JAX code makes from
its keys; ``chip_smoke.py`` replays on the card what the CPU drew).
``record=True`` keeps every draw made, in ``taken``. Real draws come in
the default dtype (float32 unless a caller sets another), integer draws as
int64.

Under data parallelism (``core/mesh.py``) a draw with one row per row of a
row set spread over the ranks (``rows=True`` at the call) is drawn for the
whole set, from the generator or from ``given``, and the rank keeps its own
rows (``split``, a ``RowSplit``): every rank draws the same numbers in the
same order, so the generators stay in step and a row gets the draw it gets
in one process. A draw without a row axis (per light, per step) is the
same on every rank.
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, generator: torch.Generator | None = None,
                 given: dict | None = None, device="cpu",
                 record: bool = False, split=None):
        self.generator = generator
        self.given = dict(given or {})
        self.device = torch.device(device)
        self.taken: dict | None = {} if record else None
        self.split = split

    def with_split(self, split) -> "Draws":
        """These draws (one generator, ``given`` and ``taken``) with per-row
        draws taken from rows ``split`` (a ``RowSplit``, or None: the rows
        asked for are the whole set)."""
        out = Draws(self.generator, device=self.device, split=split)
        out.given, out.taken = self.given, self.taken
        return out

    def _draw(self, name: str, shape, fn, dtype=None, rows: bool = False) -> torch.Tensor:
        if rows and self.split is not None:
            # the whole row set's draw, of which this rank keeps its rows;
            # a rank with no rows runs its row function on one stand-in
            # row (compact_apply), which takes the set's first
            offset, count, total = self.split
            n = shape[0]
            if n != count and not (count == 0 and n == 1):
                raise ValueError(f"draw {name!r}: {n} rows asked, the split has {count}")
            full = self._draw(name, (max(total, 1),) + tuple(shape[1:]), fn, dtype)
            start = min(offset, full.shape[0] - n)
            return full[start:start + n]
        if name in self.given:
            t = torch.as_tensor(self.given[name]).to(self.device,
                                                     dtype or torch.get_default_dtype())
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

    def uniform(self, name: str, shape, rows: bool = False) -> torch.Tensor:
        """U[0, 1) of ``shape``; ``rows``: its leading axis is the row
        set's."""
        return self._draw(name, shape, torch.rand, rows=rows)

    def normal(self, name: str, shape, rows: bool = False) -> torch.Tensor:
        """N(0, 1) of ``shape``; ``rows`` as for ``uniform``."""
        return self._draw(name, shape, torch.randn, rows=rows)

    def integers(self, name: str, shape, high: int) -> torch.Tensor:
        """Integers uniform on [0, high) of ``shape``, int64."""
        return self._draw(name, shape, lambda shape, **kw: torch.randint(high, shape, **kw),
                          torch.int64)
