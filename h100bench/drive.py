"""One run of one cell: set-up, the measured window, the traced window, the
check. Everything that belongs to a configuration, a traffic mix, a cell or
a per-layer metric is read from its own file, found by the names in
BENCHMARK.json:

- configs/<config>.json: the configuration as it is run (`config`, the
  program's config tree as a plain dict) with its source and assumptions,
  and optionally `reference`, the name of its plain reference module under
  reference/ (`episode` where it names none; see check.py);
- traffic/<mix>.json: the mix (see traffic.py);
- cells/<workload>.json: the work of one unit (work.py) and the limit of
  each number the check compares (check.py);
- metrics/<metric>.py: a reader `read(ctx) -> float | None` of one
  per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import check
import program
import traffic
import weights as weights_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell's entry, its configuration, mix, work and limits, and the
    end-to-end and per-layer metrics it reports."""
    bench = _json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names and reports(m)]
    return {"cell": cell, "config": _json(ROOT, conf["file"]), "mix": traffic.load(cell["traffic"]),
            "work": _json(HERE, "cells", f"{workload}.json"), "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Setup:
    """The program built for a configuration on a device: its config, its
    modules (bf16 compute, as the configuration states), its reference's
    name, the policies it trains and the further metrics its record keeps
    (check.py) and, per seed, the benchmark's weights, the program's state
    and the mix's pool."""

    def __init__(self, cfg_dict: dict, mix: dict, work: dict, device, dtype=None,
                 ref: str = check.DEFAULT_REFERENCE):
        self.cfg_dict, self.mix, self.work, self.device = cfg_dict, mix, work, device
        self.ref, self.policies = ref, check.policies(ref)
        self.extra_metrics = getattr(check.reference(ref), "EXTRA_METRICS", ())
        self.cfg = program.config(cfg_dict)
        self.mods = program.modules(self.cfg, device, dtype)

    def seed(self, seed: int):
        self.weights = weights_mod.draw(program.module_dict(self.mods), seed, self.device)
        self.pool = traffic.pool(self.mix, self.cfg_dict, seed, self.device)
        return program.state(self.weights)


def recorded_step(s: Setup, st, item):
    """One train step through the window's call, recorded for the check:
    (state, record). The record keeps device tensors, so that a step inside
    the window waits for nothing; `on_host` reads them once it has closed."""
    pairs: List = []
    losses: Dict[str, List] = {}
    with program.record_pairs(s.mods, pairs), program.record_losses(losses):
        st, metrics, recon = program.train_step(st, s.mods, s.cfg, item["video"], item["org"],
                                                item["gumbel"])
    return st, {"pairs": torch.stack([a for a, _ in pairs]),
                "logp": torch.stack([lp for _, lp in pairs]),
                "recon": recon.detach(),
                "metrics": {**{k: metrics[f"{g}/{k}"].detach() for g, k in (
                    ("Episode", "lpips_loss"), ("Episode", "mean_reward"),
                    ("PPO", "actor_loss"), ("PPO", "critic_loss"))},
                    **{k: metrics[k].detach() for k in s.extra_metrics}},
                "epoch_losses": {k: losses[k] for k in ("actor", "critic")},
                "targets": losses["targets"][0].detach()}


def on_host(rec: dict) -> dict:
    """A record's scalars as floats, its reconstruction on the host."""
    return {**rec, "recon": rec["recon"].cpu(), "targets": rec["targets"].float(),
            "metrics": {k: v.item() for k, v in rec["metrics"].items()},
            "epoch_losses": {k: [x.item() for x in v] for k, v in rec["epoch_losses"].items()}}


def _copy(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


def policies(st, names) -> dict:
    """A copy of the parameters and Adam states of the policies `names` in `st`."""
    return {n: {"params": _copy(getattr(st, f"{n}_params")),
                "step": getattr(st, f"{n}_opt")["step"],
                "m": _copy(getattr(st, f"{n}_opt")["exp_avg"]),
                "v": _copy(getattr(st, f"{n}_opt")["exp_avg_sq"])} for n in names}


def train_records(s: Setup, st, units: int):
    """`units` train steps through the window's call on the pool's first
    batches, each recorded for the check. Returns (state, records)."""
    records = []
    for i in range(units):
        st, rec = recorded_step(s, st, s.pool[i % len(s.pool)])
        rec = on_host(rec)
        if i == 0:
            rec["moments"] = {n: dict(getattr(st, f"{n}_opt")["exp_avg"]) for n in s.policies}
        records.append(rec)
    records[-1]["params"] = {n: dict(getattr(st, f"{n}_params")) for n in s.policies}
    return st, records


def window_step(seed: int) -> int:
    """The window's step that the check records, 1 or 2 as the seed draws:
    never its first, so that whatever a step does only on its first call
    in the window (a graph captured, a cast cached) has been done."""
    return 1 + traffic.stream(seed, 11) % 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(units, step, device) -> float:
    """Wall seconds of `units` calls of step(k), unprofiled."""
    _sync(device)
    t0 = time.perf_counter()
    for k in range(units):
        step(k)
    _sync(device)
    return time.perf_counter() - t0


def _traced(calls, step, device) -> dict:
    """`calls` calls of step(k) timed unprofiled, then `calls` more under
    the profiler: the trace's analysis with the profiled window's seconds
    (`window_s`) and the unprofiled ones (`timed_s`), which the rates and
    shares of the wall time read, since the profiler's host work stretches
    a host-bound unit. The trace is written under TMPDIR and deleted."""
    from torch.profiler import ProfilerActivity, profile

    import trace

    timed = _timed(calls, step, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    with tempfile.TemporaryDirectory(prefix="h100bench_trace_") as tmp:
        with profile(activities=acts) as prof:
            window = _timed(calls, step, device)
        path = os.path.join(tmp, "trace.json")
        t1 = time.perf_counter()
        prof.export_chrome_trace(path)
        del prof
        size, t2 = os.path.getsize(path), time.perf_counter()
        analysis = trace.analyze(path)
        print(f"h100bench: trace {size / 1e6:.1f} MB, exported in {t2 - t1:.1f} s, read in "
              f"{time.perf_counter() - t2:.1f} s", file=sys.stderr)
    return dict(window_s=window, timed_s=timed, **analysis)


def _launch_check(s: Setup, before: Dict[str, int], units: int) -> None:
    """Every unit of the window launched the port's kernels as the cell's
    work file says (only on CUDA: on the CPU the kernels' twins run)."""
    want = s.work["launches"]
    got = {k: v - before[k] for k, v in program.launches().items()}
    if torch.device(s.device).type == "cuda" and got != {k: n * units for k, n in want.items()}:
        raise RuntimeError(f"kernel launches over {units} units: {got}, expected "
                           f"{want} per unit: the cell left its path")


def run_cell(c: dict, seed: int, seconds: float, traced: bool, device, start: float,
             dtype=None, setup: Optional[Setup] = None, detail: Optional[dict] = None) -> dict:
    """One run. `c` as load_cell gives it; `start`: the process's start
    (time.time()); `setup`: a Setup of the cell's configuration to reuse;
    `detail`: filled with a train check's further readings. Returns the
    result's fields, and every number the check read (`numbers`)."""
    mix, work = c["mix"], c["work"]
    s = setup or Setup(c["config"]["config"], mix, work, device, dtype,
                       c["config"].get("reference", check.DEFAULT_REFERENCE))
    st = s.seed(seed)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    res = (_train if mix["kind"] == "train" else _serve)(s, st, seed, seconds, traced, start)
    del st
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    res["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name() if cuda else "cpu",
                     "count": 1, "memory_peak_bytes": max(peak_before, peak) if cuda else 0}
    ctx = {"kind": mix["kind"], "work": work, "peak_mem_bytes": peak, **res.pop("ctx")}
    if traced:
        res["device"].update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        res["metrics"] = {}
        for m in c["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                res["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        res["metrics"] = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                          for m in c["end_to_end"]}
    setup_s = res.pop("e2e")["setup_s"]
    # the program's state is freed before the reference runs on the device
    check_args = res.pop("check")
    s.pool = s.weights = None
    if setup is None:
        del s
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.time()
    numbers = check_args(detail)
    print(f"h100bench: set-up {setup_s:.1f} s, check {time.time() - t0:.1f} s", file=sys.stderr)
    limits = work.get("limits", {})
    res["numbers"] = numbers
    res["correct"] = bool(limits) and check.verdict(numbers, limits)
    res["compared"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return res


def _train(s: Setup, st, seed, seconds, traced, start) -> dict:
    """Three recorded set-up steps, then the window's steps, each on the
    pool's next batch; the window's step `window_step(seed)` is recorded
    too, with the policies as they stood before it."""
    mix = s.mix
    b, t = s.cfg.rl.batch_size, s.cfg.rl.time_steps
    n0 = mix["setup_units"]
    st, records = train_records(s, st, n0)
    k = window_step(seed)
    done, held = [0], {}

    def step(_=None):
        nonlocal st
        item = s.pool[(n0 + done[0]) % len(s.pool)]
        if done[0] == k:
            held.update(before=policies(st, s.policies), item=item)
            st, held["record"] = recorded_step(s, st, item)
            held["after"] = {n: _copy(getattr(st, f"{n}_params")) for n in s.policies}
        else:
            st, _m, _r = program.train_step(st, s.mods, s.cfg, item["video"], item["org"],
                                            item["gumbel"])
        done[0] += 1

    before = program.launches()
    setup_s = time.time() - start
    e2e, ctx = {"setup_s": setup_s}, {}
    if traced:
        ctx = dict(units=mix["trace_units"], **_traced(mix["trace_units"], step, s.device))
    else:
        _sync(s.device)
        t0 = time.perf_counter()
        # at full size the window holds far more than k steps; a test's
        # window of a fraction of a second still reaches the recorded one
        while time.perf_counter() - t0 < seconds or done[0] <= k:
            step()
        _sync(s.device)
        e2e["train_frames_per_s"] = done[0] * b * t / (time.perf_counter() - t0)
    _launch_check(s, before, done[0])
    window = dict(held, record=on_host(held["record"]))
    feed3, cfg_dict, w, ref = s.pool[:n0], s.cfg_dict, s.weights, s.ref
    out = {"attempted": done[0], "failed": 0, "e2e": e2e, "ctx": ctx,
           "check": lambda detail=None: check.compare_train(cfg_dict, w, feed3, records, window,
                                                            detail, ref)}
    if traced:
        out["breakdown"] = ctx.pop("breakdown")
    return out


def _serve(s: Setup, st, seed, seconds, traced, start) -> dict:
    mix = s.mix
    b, t = s.cfg.rl.batch_size, s.cfg.rl.time_steps
    host = [item["video"].cpu().numpy() for item in s.pool]
    for _ in program.serve(s.cfg, st, s.mods, host[:mix["setup_units"]]):
        pass
    kept: Dict[int, tuple] = {}
    order: List[int] = []       # the pool slot of each batch handed in

    def batches(n_max: Optional[int], t0: float):
        k = 0
        while (k < n_max) if n_max is not None else (
                time.perf_counter() - t0 < seconds or k < mix["check_batches"]):
            order.append(len(order) % len(host))
            yield host[order[-1]]
            k += 1

    def serve(n_max, t0):
        for frames, pairs in program.serve(s.cfg, st, s.mods, batches(n_max, t0)):
            kept[order[len(served)]] = (frames, pairs)
            served.append(1)

    served: List[int] = []
    before = program.launches()
    setup_s = time.time() - start
    e2e, ctx = {"setup_s": setup_s}, {}
    if traced:
        units = mix["trace_units"]
        ctx = dict(units=units, **_traced(1, lambda _: serve(units, 0.0), s.device))
    else:
        t0 = time.perf_counter()
        serve(None, t0)
        e2e["serve_frames_per_s"] = len(served) * b * t / (time.perf_counter() - t0)
    _launch_check(s, before, len(served))
    rng = np.random.default_rng(traffic.stream(seed, 7))
    slots = sorted(kept)
    picked = sorted(rng.choice(slots, size=min(mix["check_batches"], len(slots)), replace=False))
    dev = s.device
    batches_for_check = [{"input": s.pool[k]["video"], "frames": torch.from_numpy(kept[k][0]),
                          "pairs": torch.from_numpy(kept[k][1]).to(dev)} for k in picked]
    cfg_dict, w, ref = s.cfg_dict, s.weights, s.ref
    out = {"attempted": len(served), "failed": 0, "e2e": e2e, "ctx": ctx,
           "check": lambda detail=None: check.compare_serve(cfg_dict, w, batches_for_check, ref)}
    if traced:
        out["breakdown"] = ctx.pop("breakdown")
    return out
