"""CESRStageConfig.ambient_anchor in the port against the JAX package: the
knob reweights the diffuse-visibility KL per light lobe, and the JAX
package applies it only in the compacted row mode, not in the dense step
(``ROADMAP.md`` section C). Inputs and tolerances of
``test_torch_cesr_rows.py``.
"""

import numpy as np

from test_torch_cesr import case  # noqa: F401  (the shared fixtures)
from test_torch_cesr_rows import grid_case, jax_rows, port_rows  # noqa: F401


def test_ambient_anchor_applies_in_row_mode_only(grid_case):  # noqa: F811
    """ambient_anchor=2 moves the row-mode sv_loss of a warmup step in both
    packages (and the port's equals JAX's); the dense step ignores the
    knob, bit for bit, as the JAX dense step does."""
    sv = {}
    for aa in (0.0, 2.0):
        _, jm = jax_rows(grid_case, "warmup", False, False, ambient_anchor=aa)
        _, tm, _ = port_rows(grid_case, "warmup", False, False, ambient_anchor=aa)
        np.testing.assert_allclose(tm["sv_loss"].item(), float(jm["sv_loss"]), rtol=1e-5)
        _, dense, _ = port_rows(grid_case, "warmup", False, False, chunk=0, ambient_anchor=aa)
        sv[aa] = float(jm["sv_loss"]), tm["sv_loss"].item(), dense["sv_loss"].item()
    # each moves by far more than the 1e-5 the packages agree to
    assert abs(sv[2.0][0] - sv[0.0][0]) > 1e-4 * abs(sv[0.0][0])
    assert abs(sv[2.0][1] - sv[0.0][1]) > 1e-4 * abs(sv[0.0][1])
    assert sv[2.0][2] == sv[0.0][2]
