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

``PaddedDraws`` holds a step's draws in buffers of fixed shape and address
for a render padded to B rows of which the first k are needed (the CUDA
graphs of ``stages/material_graph.py``): the draws its render asks for are
noted once, in order, and each step ``fill`` draws them from a generator
as the unpadded render would, k rows of each per-row draw (one where k is
0), and copies the first row into the padding rows, so that the generator
moves exactly as in the eager step.
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


class _Slot:
    """One draw of a padded step: its name, shape, function and dtype,
    whether it takes the needed rows only (a per-row draw of the padded
    rows), and its buffer."""

    def __init__(self, name, shape, fn, dtype, per_row, buf):
        self.name, self.shape, self.fn, self.dtype = name, shape, fn, dtype
        self.per_row, self.buf = per_row, buf


class _Book:
    """The slots shared by a ``PaddedDraws`` and its ``rows()`` view, and
    the mode their requests are served in: "draw" (allocate, note and draw
    at once from ``generator``), "static" (hand out the slots' buffers in
    order)."""

    def __init__(self):
        self.slots: list[_Slot] = []
        self.cursor, self.mode = 0, "static"
        self.generator, self.k = None, 0


class PaddedDraws(Draws):
    """A padded step's draws for ``padded`` rows (B) in fixed buffers: noted
    once in the order a render asks for them (``draw_now``, whose slots
    ``spec`` describes), or laid out from such a ``spec`` (``allocate``);
    then each step ``fill(generator, k)`` draws every slot in that order,
    and ``serve()`` hands the buffers out again in it (a request that
    differs from its slot raises). A CUDA graph reads the buffers
    ``allocate`` made before its capture: a buffer made during a capture
    is, to the graph, memory of its own that an earlier kernel may
    overwrite."""

    def __init__(self, padded: int, device, book: _Book | None = None, row_scope: bool = False):
        super().__init__(device=device)
        self.padded = padded
        self._book = _Book() if book is None else book
        self._row_scope = row_scope

    def rows(self) -> "PaddedDraws":
        """The draws the padded render's rows ask for: the same slots, its
        per-row draws kept to the needed rows."""
        return PaddedDraws(self.padded, self.device, self._book, row_scope=True)

    def spec(self) -> list:
        """(name, shape, function, dtype, per-row) of each slot, in order; a
        per-row slot's shape without its leading axis (the padded rows)."""
        return [(s.name, s.shape[1:] if s.per_row else s.shape, s.fn, s.dtype, s.per_row)
                for s in self._book.slots]

    def allocate(self, spec: list) -> None:
        """Slots laid out from ``spec`` (another ``PaddedDraws``'s, of any
        padded rows), each with a buffer of its own."""
        self._book.slots = []
        for name, shape, fn, dtype, per_row in spec:
            shape = (self.padded,) + shape if per_row else shape
            self._book.slots.append(_Slot(name, shape, fn, dtype, per_row, torch.empty(
                shape, dtype=dtype, device=self.device)))
        self.serve()

    def draw_now(self, generator: torch.Generator, k: int) -> None:
        """Requests allocate, note and draw their slots at once."""
        book = self._book
        book.slots, book.cursor, book.mode = [], 0, "draw"
        book.generator, book.k = generator, k

    def serve(self) -> None:
        """Requests take the slots' buffers, in order."""
        self._book.cursor, self._book.mode = 0, "static"

    def fill(self, generator: torch.Generator, k: int) -> None:
        """Every slot's draw from ``generator`` for ``k`` needed rows."""
        for slot in self._book.slots:
            self._fill(slot, generator, k)

    def _fill(self, slot: _Slot, generator: torch.Generator, k: int) -> None:
        if slot.per_row:
            r = max(k, 1)
            t = slot.fn((r,) + slot.shape[1:], generator=generator, device=self.device)
            slot.buf[:r].copy_(t)
            slot.buf[r:].copy_(t[:1].expand((slot.shape[0] - r,) + slot.shape[1:]))
        else:
            slot.buf.copy_(slot.fn(slot.shape, generator=generator, device=self.device))

    def _draw(self, name: str, shape, fn, dtype=None, rows: bool = False) -> torch.Tensor:
        book, shape = self._book, tuple(shape)
        per_row = rows and self._row_scope
        if book.mode == "static":
            if book.cursor >= len(book.slots):
                raise KeyError(f"draw {name!r}: the step noted {len(book.slots)} draws")
            slot = book.slots[book.cursor]
            if (slot.name, slot.shape, slot.per_row) != (name, shape, per_row):
                raise KeyError(f"draw {name!r} {shape}: the step noted {slot.name!r} "
                               f"{slot.shape} here")
            book.cursor += 1
            return slot.buf
        if per_row and shape[0] != self.padded:
            raise ValueError(f"draw {name!r}: {shape[0]} rows asked, the padded rows are "
                             f"{self.padded}")
        dtype = dtype or torch.get_default_dtype()
        slot = _Slot(name, shape, fn, dtype, per_row,
                     torch.empty(shape, dtype=dtype, device=self.device))
        book.slots.append(slot)
        self._fill(slot, book.generator, book.k)
        return slot.buf
