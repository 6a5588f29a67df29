"""The port's PBR step in row mode (surface-pixel compaction, compact chunk
16: the batch's 34 surface rows in three chunks) against the JAX
package's compacted ``make_pbr_step``, shading with the AE normal map: the
inputs, draws, checks and tolerances of ``test_torch_pbr.py``. The JAX
compacted step compiles for over 10 s on the CPU, so the dense step
(``test_torch_pbr.py``) and row mode on the geometry normals
(``test_torch_pbr_rows_geometry.py``) have files of their own.
"""

from test_torch_pbr import CHUNK, assert_step_matches
from test_torch_pbr import case  # noqa: F401  (the shared fixture)


def test_row_mode_pbr_step_matches_jax(case):  # noqa: F811
    assert_step_matches(case, CHUNK, use_normal_map=True)
