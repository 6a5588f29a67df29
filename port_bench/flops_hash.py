"""The hash-grid NeuS step's operation and byte counts (the conventions of
``flops.py``: a multiply-add counts as 2; a count is what the step needs
at its shapes, not what the program launches).

The head (fp32, ``reference/neus_hash.py``'s ReLU layers) is counted as
``flops.trunk_row_flops`` counts a trunk of its widths without an encoding
or skip: a sampling query the sdf column alone (``K1_sdf``), a shaded
point the forward and d sdf/d encoding (``K3``) and their backward
(``K4``); the colour net (bf16 storage) 3 x its forward at every shaded
point.

The encoding's least bytes: 8 B (F = 2 fp32 entries) read a lookup at
every encoded point, 8 B of table gradient written a shaded point's
lookup, and 12 B in (the point) and 4 x L x F B out (its features) an
encoded point; 32-byte sectors and the random reads' waste not counted.
"""

from __future__ import annotations

from .flops import n_weights, trunk_row_flops
from .weights import color_layers

# NVIDIA H100 SXM data sheet: HBM3 bandwidth
PEAK_BYTES_S = 3.35e12


def hash_step_work(model: dict, render: dict, batch: int) -> dict:
    """The step's matrix work by precision, the encoding's least bytes
    (``hash_bytes``) and its points: the sdf at the sampling queries (the
    first ``n_samples`` and every up-sampling round but the last), value,
    gradient and their backward at every shaded sample."""
    steps = render["up_sample_steps"]
    queried = batch * (render["n_samples"] + render["n_importance"] // steps * (steps - 1))
    shaded = batch * (render["n_samples"] + render["n_importance"])
    hs = model["hash_sdf"]
    grid = hs["grid"]
    row = trunk_row_flops({"d_in": grid["n_levels"] * grid["n_features"], "multires": 0,
                           "d_hidden": hs["width"], "n_layers": hs["depth"],
                           "d_out": hs["d_out"], "skip_in": []})
    head = queried * row["K1_sdf"] + shaded * (row["K3"] + row["K4"])
    color = shaded * 3 * 2 * n_weights(color_layers(model["color"]))
    corners = 8 * grid["n_levels"]
    entry = 4 * grid["n_features"]
    points = queried + shaded
    hash_bytes = (points * (corners * entry + 12 + grid["n_levels"] * entry)
                  + shaded * corners * entry)
    return {"flops": {"fp32": head, "bf16": color}, "hash_bytes": hash_bytes,
            "rows": {"queried": queried, "shaded": shaded, "points": points}}
