"""The check that nothing the benchmark ran loaded JAX or the JAX package.

Module names are compared by their top-level name, the part before the
first dot, whole: ``robir_tpu_torch`` is the port, ``robir_tpu`` the JAX
package.
"""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "robir_tpu", "bench", "chip_smoke",
                       "kernel_times"})


def forbidden(module_names) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    return sorted(n for n in module_names if n.split(".", 1)[0] in FORBIDDEN)
