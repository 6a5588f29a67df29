"""Readings from which a cell's limits are set, in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \
        [--judged program control half_batch]

For each seed it does the cell's set-up (the program's first steps, as a
run does), frees the program, and prints one JSON line a judged subject
with the numbers ``correct`` compares: ``program`` (a sound run), ``control``
(the reference in the precision below the configuration's, in the
program's place) and ``half_batch`` (the reference with half of each batch
left out). No window is timed. It needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from port_bench import manifest  # noqa: E402


def readings(workload: str, seeds, judged, device, root: str = manifest.ROOT):
    """Yield ``{"seed", "judged", <number>: value, ...}`` for each seed and
    judged subject."""
    cell_def = manifest.load_cell(workload, root)
    stage = manifest.stage_module(cell_def["stage"])
    for seed in seeds:
        t = time.perf_counter()
        cell = stage.build(cell_def["config"], cell_def["traffic"], seed % 2 ** 63, device)
        cell.release()
        for subject in judged:
            numbers = cell.compare(subject)
            yield {"seed": seed, "judged": subject, "seconds": time.perf_counter() - t,
                   **{k: v for k, (v, _) in numbers.items()},
                   "worst": {k: w for k, (_, w) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--judged", nargs="+", default=["program", "control"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for line in readings(args.workload, args.seeds, args.judged, torch.device("cuda")):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
