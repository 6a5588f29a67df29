"""The port's PBR step in row mode against the JAX package's compacted
``make_pbr_step``, shading with the geometry normals
(``use_normal_map=False``, where K3's normals set the shading): the
inputs, draws, checks and tolerances of ``test_torch_pbr.py``
(``test_torch_pbr_rows.py`` says why this is a file of its own).
"""

from test_torch_pbr import CHUNK, assert_step_matches
from test_torch_pbr import case  # noqa: F401  (the shared fixture)


def test_row_mode_pbr_step_on_geometry_normals_matches_jax(case):  # noqa: F811
    assert_step_matches(case, CHUNK, use_normal_map=False)
