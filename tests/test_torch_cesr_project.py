"""The port's CESR project step in row mode on the grid tracer against the
JAX package's compacted step: the third phase of
``test_torch_cesr_rows.py``'s check, in a file of its own because the JAX
step compiles for about 17 s on the CPU. Same inputs and tolerances.
"""

from test_torch_cesr import case  # noqa: F401  (the shared fixtures)
from test_torch_cesr import assert_step_matches
from test_torch_cesr_rows import grid_case, jax_rows, port_rows  # noqa: F401


def test_row_mode_project_step_matches_jax(grid_case):  # noqa: F811
    jgrads, metrics = jax_rows(grid_case, "project", True, True)
    _, tmetrics, tparams = port_rows(grid_case, "project", True, True)
    assert_step_matches(tmetrics, tparams, metrics, jgrads)
