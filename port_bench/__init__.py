"""The benchmark of ``robir_tpu_torch`` on one NVIDIA H100.

``python port_bench/run.py --workload <config>.<mix> --seed N --seconds S
--trace 0|1`` runs one cell once and prints one JSON line. A cell's
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<mix>.json`` (whose ``stage`` names the driver under
``stages/``), its limits ``limits/<cell>.json``; each per-layer metric is
``metrics/<metric>.py``; the kernel names of a layer are the lines of the
files under ``layers/<layer>/``. Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""
