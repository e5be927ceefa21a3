"""Run one cell of the port's H100 benchmark once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's set-up (the port's modules, the
weights and the input pool drawn from the seed on the card, the warm-up
units) counts as `setup_s`; then the window measures for `--seconds`
(`--trace 0`: the end-to-end metrics) or the profiler traces a fixed
number of units (`--trace 1`: the per-layer metrics). After the window the
check compares what the timed path produced with the plain reference.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error. Exits non-zero,
printing no result, without a CUDA card.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rovr_tpu", "__graft_entry__")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [HERE, ROOT]

    import torch

    import drive

    c = drive.load_cell(args.workload)
    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = drive.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"h100bench: the run loaded {loaded}", file=sys.stderr)
        return 3
    res.pop("numbers")
    compared = res.pop("compared")
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = compared
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
