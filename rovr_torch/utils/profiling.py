"""Tracing and profiling (rovr_tpu/utils/profiling.py, PyTorch port).

`trace(logdir)` profiles a region with torch.profiler (the host's ops, and
the card's kernels and copies where CUDA is visible) and writes a Chrome
trace, `<logdir>/trace.json`, that Perfetto or chrome://tracing opens;
`annotate(name)` names a sub-region on its timeline. `analyze_trace` reads
such a trace back: the device's busy time and idle share, its time by
stream, its top kernels and the host's top ops, and the annotated ranges
with the device work each launched. `StepTimer` times steps
that end in a device synchronize. `device_memory_stats` reads the caching
allocator's live bytes per card. `tree_tensors` walks a tree of tensors.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
# Chrome-trace categories of work on the device; "gpu_user_annotation" (a
# record_function range's span on the device timeline) is not work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side launches, which carry the correlation id of the device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: `with trace("runs/prof"): step(...)`. The device
    is synchronized before the profiler stops, so the region's kernels are
    in the trace; the trace is written even when the region raises."""
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A named sub-region inside a trace (a `record_function` range)."""
    return record_function(name)


def tree_tensors(tree):
    """The tensors of a tree of tuples (named ones too), lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tree_tensors(v)


class StepTimer:
    """Wall-clock time of device steps, each ended by a device synchronize.

    Usage:
        timer = StepTimer()
        with timer.step():
            out = train_step(...)
            timer.sync(out)
        print(timer.summary())
    """

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self.skip_first = skip_first

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def sync(self, tree) -> None:
        """Wait for the devices that hold the tree's tensors (PyTorch returns
        before a CUDA kernel finishes)."""
        for dev in {t.device for t in tree_tensors(tree) if t.is_cuda}:
            torch.cuda.synchronize(dev)

    @property
    def steady(self) -> List[float]:
        return self.times[self.skip_first:] if len(self.times) > self.skip_first \
            else self.times

    def summary(self) -> Dict[str, float]:
        ts = sorted(self.steady)
        if not ts:
            return {}
        return {"steps": float(len(ts)), "mean_s": sum(ts) / len(ts),
                "p50_s": ts[len(ts) // 2], "max_s": ts[-1]}


def _union_ms(spans) -> float:
    """Length of the union of (start, end) spans, in ms (spans in us)."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _stream_of(event: Dict[str, object]):
    """The stream a device event of a Chrome trace ran on."""
    return event.get("args", {}).get("stream", event.get("tid"))


def _streams(dev: List[dict]) -> Dict[object, Dict[str, float]]:
    """{stream: {ms, window_ms, others_busy_share}}: each stream's device
    work summed, the window from its first start to its last end, and the
    share of that window in which any other stream ran work."""
    spans = collections.defaultdict(list)
    for e in dev:
        spans[_stream_of(e)].append((e["ts"], e["ts"] + e["dur"]))
    out = {}
    for st, own in spans.items():
        lo, hi = min(a for a, _ in own), max(b for _, b in own)
        others = [(max(a, lo), min(b, hi)) for o, sp in spans.items() if o != st
                  for a, b in sp if a < hi and b > lo]
        out[st] = {"ms": sum(b - a for a, b in own) / 1e3, "window_ms": (hi - lo) / 1e3,
                   "others_busy_share": _union_ms(others) * 1e3 / (hi - lo) if hi > lo else 0.0}
    return out


def _range_streams(events: List[dict], dev: List[dict]) -> Dict[str, Dict[object, List]]:
    """{range: {stream: [ms, count]}} of the device work launched from
    inside each `annotate` range: a launch on the range's host thread
    within its span, matched to its device work by correlation id."""
    by_corr = collections.defaultdict(list)
    for e in dev:
        if "correlation" in e.get("args", {}):
            by_corr[e["args"]["correlation"]].append(e)
    launches = collections.defaultdict(list)   # (pid, tid) -> [(ts, correlation)]
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[(e.get("pid"), e.get("tid"))].append((e["ts"], e["args"]["correlation"]))
    for v in launches.values():
        v.sort()
    out: Dict[str, Dict[object, List]] = {}
    for r in events:
        if r.get("cat") != "user_annotation":
            continue
        per = out.setdefault(r["name"], {})
        thread = launches.get((r.get("pid"), r.get("tid")), [])
        lo = bisect.bisect_left(thread, (r["ts"], -1))
        hi = bisect.bisect_right(thread, (r["ts"] + r["dur"], float("inf")))
        for _, corr in thread[lo:hi]:
            for k in by_corr.get(corr, ()):
                acc = per.setdefault(_stream_of(k), [0.0, 0])
                acc[0] += k["dur"] / 1e3
                acc[1] += 1
    return out


def analyze_trace(logdir: str, top: int = 25) -> Dict[str, object]:
    """Read the newest Chrome trace under `logdir` (what `trace` writes, or
    any torch.profiler `export_chrome_trace`) and return:

    - `wall_ms`: from the trace's first event to its last;
    - `device_ms`: the device's kernels, copies and sets summed, and
      `busy_ms`, the union of their spans (streams may overlap);
    - `idle_share`: 1 - busy_ms / wall_ms (None when the trace holds no
      device work, as on the CPU);
    - `top_device` and `top_host`: (name, ms, count) by total time, of the
      device's work and of the host's ops;
    - `ranges`: {name: (host ms, count)} of the `annotate` ranges;
    - `streams`: {stream: {ms, window_ms, others_busy_share}}: the
      device's work by stream, the window from the stream's first start to
      its last end, and the share of that window in which other streams
      ran work;
    - `range_streams`: {name: {stream: [ms, count]}}, the device work that
      each range's ops launched (matched by correlation id), by stream.

    Annotation rows on the device timeline (a range's span) are left out of
    the device's time: they would count its kernels twice."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{paths[-1]} holds no complete events")
    start = min(e["ts"] for e in events)
    wall_ms = (max(e["ts"] + e["dur"] for e in events) - start) / 1e3
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ms, n, host_ms, host_n, rng_ms, rng_n = (collections.Counter() for _ in range(6))
    for e in dev:
        ms[e["name"]] += e["dur"] / 1e3
        n[e["name"]] += 1
    for e in events:
        if e.get("cat") == "cpu_op":
            host_ms[e["name"]] += e["dur"] / 1e3
            host_n[e["name"]] += 1
        elif e.get("cat") == "user_annotation":
            rng_ms[e["name"]] += e["dur"] / 1e3
            rng_n[e["name"]] += 1
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev)
    return {
        "trace": paths[-1], "wall_ms": wall_ms, "device_ms": sum(ms.values()),
        "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms if dev else None,
        "top_device": [(k, v, n[k]) for k, v in ms.most_common(top)],
        "top_host": [(k, v, host_n[k]) for k, v in host_ms.most_common(top)],
        "ranges": {k: (v, rng_n[k]) for k, v in rng_ms.items()},
        "streams": _streams(dev),
        "range_streams": _range_streams(events, dev),
    }


def format_trace_report(report: Dict[str, object]) -> str:
    idle = report["idle_share"]
    lines = [f"wall {report['wall_ms']:.3f} ms, device busy {report['busy_ms']:.3f} ms "
             f"(kernels and copies summed {report['device_ms']:.3f} ms), idle share "
             + ("not measured (no device work in the trace)" if idle is None
                else f"{idle:.3f}")]
    if report["streams"]:
        lines.append("device by stream: " + ", ".join(
            f"{k} {v['ms']:.3f} ms" for k, v in sorted(report["streams"].items(), key=str)))
    for title, key in (("device", "top_device"), ("host ops", "top_host")):
        if report[key]:
            lines.append(f"top {title}:")
            lines += [f"  {ms:9.3f} ms {cnt:6d}x  {name[:100]}" for name, ms, cnt in report[key]]
    if report["ranges"]:
        lines.append("annotated ranges (host):")
        lines += [f"  {ms:9.3f} ms {cnt:6d}x  {name}"
                  for name, (ms, cnt) in sorted(report["ranges"].items())]
    return "\n".join(lines)


def device_memory_stats() -> Dict[str, float]:
    """GB allocated now on each visible card (the reference's CUDA memory
    prints, test.py:66); an empty dict without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {str(i): torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0) / 1e9
            for i in range(torch.cuda.device_count())}
