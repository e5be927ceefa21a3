"""The program's spans in one cell, on the card.

    python3 h100bench/spans.py --workload <cell> --seed <n> [--units <k>]

After the cell's set-up (its modules, weights and pool as run.py builds
them, then the mix's set-up units), the same `--units` units (default: the
mix's `trace_units`) run unprofiled (`timed_s`) and inside the program's
span recorder, `rovr_torch.utils.profiling.recording` (`recorded_s`), in
turns, PAIRS times each (`recording_cost`: the median of the pairs'
ratios, less 1), then once under `profiling.trace`, whose
`analyze_trace` puts the device's idle gaps down to the spans open across
them (`idle_ms`). Prints one JSON line: per unit, each span's count, host
ms (recorded) and device ms (profiled); the share of each unit's host time
that its root's direct children cover (`children_cover`); the share of the
idle time inside units that falls on a span below the root
(`idle_below_root`); and the idle time outside every unit. Not part of a
benchmark run. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import drive  # noqa: E402
import program  # noqa: E402
from rovr_torch.utils import profiling  # noqa: E402

ROOTS = {"train": "rovr/train_step", "serve": "rovr/serve/batch"}
PAIRS = 3


def unit_runner(s: drive.Setup, seed: int):
    """(the units' function run(n), after the mix's set-up units): n train
    steps on the pool's next batches, or one serving call over n of the
    pool's batches, as drive.py's window makes them."""
    st = [s.seed(seed)]
    mix = s.mix
    if mix["kind"] == "train":
        done = [0]

        def run(n):
            for _ in range(n):
                item = s.pool[done[0] % len(s.pool)]
                st[0], _m, _r = program.train_step(st[0], s.mods, s.cfg, item["video"],
                                                   item["org"], item["gumbel"])
                done[0] += 1
    else:
        host = [item["video"].cpu().numpy() for item in s.pool]

        def run(n):
            for _ in program.serve(s.cfg, st[0], s.mods, [host[k % len(host)] for k in range(n)]):
                pass

    run(mix["setup_units"])
    drive._sync(s.device)
    return run


def summary(spans, idle, range_streams, root: str, units: int) -> dict:
    """Per unit: each span's count, host ms (the recorded `spans`) and device
    ms (the profiled pass's `range_streams`), the coverage of the `root`
    spans by their direct children, and the idle ms by span (`idle`, the
    profiled pass's `idle_by_range`)."""
    count, host_ms = collections.Counter(), collections.Counter()
    cover, children = [], collections.Counter()
    for sp in spans:
        count[sp.name] += 1
        host_ms[sp.name] += sp.ms
        if sp.parent is not None and spans[sp.parent].parent is None:
            children[sp.parent] += sp.ms
    for i, sp in enumerate(spans):
        if sp.parent is None and sp.name == root:
            cover.append(children[i] / sp.ms)
    in_units = sum(v for k, v in idle.items() if k != profiling.NO_RANGE)
    dev_ms = {k: sum(ms for ms, _ in v.values()) / units for k, v in range_streams.items()}
    return {
        "spans": {k: {"count": count[k] / units, "host_ms": host_ms[k] / units,
                      "device_ms": dev_ms.get(k)} for k in sorted(count)},
        "children_cover": {"min": min(cover), "mean": sum(cover) / len(cover)},
        "idle_ms": {k: v / units for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_below_root": (in_units - idle.get(root, 0.0)) / in_units if in_units else None,
        "idle_outside_units_ms": idle.get(profiling.NO_RANGE, 0.0) / units,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("h100bench: spans.py needs a CUDA card", file=sys.stderr)
        return 2
    c = drive.load_cell(args.workload)
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cuda")
    units = args.units or c["mix"]["trace_units"]
    run = unit_runner(s, args.seed)
    timed, recorded = [], []
    for _ in range(PAIRS):
        timed.append(drive._timed(1, lambda _: run(units), "cuda"))
        with profiling.recording() as spans:
            recorded.append(drive._timed(1, lambda _: run(units), "cuda"))
    with tempfile.TemporaryDirectory(prefix="h100bench_spans_") as tmp:
        with profiling.trace(tmp):
            run(units)
        report = profiling.analyze_trace(tmp)
    kind = c["mix"]["kind"]
    line = {"workload": args.workload, "seed": args.seed, "units": units,
            "device": torch.cuda.get_device_name(), "timed_s": timed, "recorded_s": recorded,
            "recording_cost": statistics.median(r / t for r, t in zip(recorded, timed)) - 1.0,
            "busy_ms": report["busy_ms"] / units, "wall_ms": report["wall_ms"] / units,
            **summary(spans, report["idle_by_range"], report["range_streams"], ROOTS[kind],
                      units)}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
