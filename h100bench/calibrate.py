"""The readings that a cell's limits are set from, on the card.

    python3 h100bench/calibrate.py --workload <cell> --seeds 12 --controls 3 --faults 3

For one cell, in one process: the program's sound runs on `--seeds`
seeds (the lower readings), the control (the reference computed with fp8
products in the program's place; check.py) and each planted fault
(faults.py) on their own seeds (the upper readings). Each reading is one
JSON line on standard output. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import check  # noqa: E402
import drive  # noqa: E402
import faults  # noqa: E402


def readings(c: dict, s: drive.Setup, seed: int, arm: str, device, detail=None) -> dict:
    """The numbers of one seed under `arm`: "sound" or a fault, a run of
    the cell as run.py makes it with a window of no length (the set-up's
    units, and the window's units up to the one the check records);
    "control" or "tf32" (a train cell's reference with TF32 in the
    program's place), the set-up's units (`detail`: filled with a train
    cell's further readings)."""
    kind = s.mix["kind"]
    if arm in ("sound",) + (faults.TRAIN if kind == "train" else faults.SERVE):
        with faults.planted(arm, kind, s.mods) if arm != "sound" else nullcontext():
            return drive.run_cell(c, seed, 0.0, False, device, time.time(), setup=s,
                                  detail=detail)["numbers"]
    s.seed(seed)
    if kind == "train":
        feed = s.pool[:s.mix["setup_units"]]
        with check.full_f32() if arm == "control" else tf32():
            recs = check.reference_train(s.cfg_dict, s.weights, feed,
                                         precision="fp8" if arm == "control" else "f32",
                                         ref=s.ref)
        return check.compare_train(s.cfg_dict, s.weights, feed, recs, detail=detail, ref=s.ref)
    picked = list(range(s.mix["check_batches"]))
    with check.full_f32():
        outs = [check.reference_serve(s.cfg_dict, s.weights, s.pool[k]["video"], "fp8", s.ref)
                for k in picked]
    batches = [{"input": s.pool[k]["video"], "frames": o["frames"], "pairs": o["pairs"]}
               for k, o in zip(picked, outs)]
    return check.compare_serve(s.cfg_dict, s.weights, batches, s.ref)


@contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--base", type=int, default=3_000_000_000)
    ap.add_argument("--arms", default="")
    ap.add_argument("--also", default="", help="further sound seeds, comma-separated")
    ap.add_argument("--tf32", default="", help="seeds for the reference with TF32 in the "
                    "program's place, comma-separated")
    args = ap.parse_args()
    c = drive.load_cell(args.workload)
    device = "cuda"
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], device,
                    ref=c["config"].get("reference", check.DEFAULT_REFERENCE))
    kind = c["mix"]["kind"]
    plan = [("sound", args.seeds), ("control", args.controls)]
    plan += [(f, args.faults) for f in (faults.TRAIN if kind == "train" else faults.SERVE)]
    if args.arms:
        plan = [(a, n) for a, n in plan if a in args.arms.split(",")]
    seeds = {arm: [args.base + 1000 * k + i for i in range(n)] for k, (arm, n) in enumerate(plan)}
    seeds["sound"] = [int(x) for x in args.also.split(",") if x] + seeds.get("sound", [])
    if args.tf32:
        plan.append(("tf32", 0))
        seeds["tf32"] = [int(x) for x in args.tf32.split(",")]
    for arm, _ in plan:
        for seed in seeds[arm]:
            t0 = time.time()
            detail = {}
            out = readings(c, s, seed, arm, device, detail)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "arm": arm, "seed": seed,
                              "seconds": round(time.time() - t0, 1), **out, "detail": detail}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
