"""Tracing and profiling (rovr_tpu/utils/profiling.py, PyTorch port).

`annotate(name)` is the program's span, a context manager or a decorator.
With nothing watching it checks two flags and does nothing else. While a
profiler runs it opens a `record_function` range, which lands on the
profiler's clock beside the device's kernels. Inside
`with recording() as spans:` it appends a `Span` to `spans` on the host's
clock (`time.perf_counter_ns`), with the index of its parent and of its
root, the outermost span open on its thread: one unit of work, such as a
train step or a served batch.

`trace(logdir)` profiles a region with torch.profiler (the host's ops, and
the card's kernels and copies where CUDA is visible) and writes a Chrome
trace, `<logdir>/trace.json`, that Perfetto or chrome://tracing opens.
`analyze_trace` reads such a trace back: the device's busy time and idle
share, its time by stream, its top kernels and the host's top ops, the
annotated ranges with the device work each launched, and the device's idle
gaps put down to the ranges open across them. `tree_tensors` walks a tree
of tensors.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
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


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span. `root` and `parent` index the recording's list:
    a root's `root` is its own index and its `parent` None. Times are
    `time.perf_counter_ns()`; `t1_ns` is None while the span is open."""

    name: str
    root: int
    parent: Optional[int]
    t0_ns: int
    t1_ns: Optional[int] = None

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Recording:
    """The spans of one `recording()` block, with a stack of the open ones
    per host thread, so that spans of other threads do not interleave."""

    def __init__(self):
        self.spans: List[Span] = []
        self._stacks: Dict[int, List[int]] = {}
        self._lock = threading.Lock()

    def open(self, name: str) -> int:
        t0 = time.perf_counter_ns()
        stack = self._stacks.setdefault(threading.get_ident(), [])
        with self._lock:
            i = len(self.spans)
            self.spans.append(Span(name, stack[0] if stack else i,
                                   stack[-1] if stack else None, t0))
        stack.append(i)
        return i

    def close(self, i: int) -> None:
        self.spans[i].t1_ns = time.perf_counter_ns()
        self._stacks[threading.get_ident()].remove(i)


_RECORDING: Optional[_Recording] = None


@contextlib.contextmanager
def recording():
    """Record every `annotate` span entered in the block, on every thread:
    `with recording() as spans: step(...)`, then read `spans` (a list of
    `Span`). Spans are kept in memory only."""
    global _RECORDING
    outer, _RECORDING = _RECORDING, _Recording()
    try:
        yield _RECORDING.spans
    finally:
        _RECORDING = outer


class annotate:
    """A span named `name`: `with annotate("rovr/rollout"): ...`, or
    `@annotate("rovr/episode_init")` on a function. Off (no recording, no
    profiler) it costs two flag reads; while a profiler runs it opens a
    `record_function` range; inside `recording()` it appends a `Span`. It
    closes when its body raises."""

    _on = False   # set on an instance only when the span is watched

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORDING
        if rec is None and not _autograd_profiler._is_profiler_enabled:
            return self
        self._on = True
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._rec = rec
        if rec is not None:
            self._index = rec.open(self.name)
        return self

    def __exit__(self, *exc):
        if not self._on:
            return False
        self._on = False
        if self._rec is not None:
            self._rec.close(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


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


def _union(spans) -> List[Tuple[float, float]]:
    """The union of (start, end) spans as disjoint sorted spans."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _union_ms(spans) -> float:
    """Length of the union of (start, end) spans, in ms (spans in us)."""
    return sum(e - s for s, e in _union(spans)) / 1e3


NO_RANGE = "(no range)"


def _idle_by_range(busy: List[Tuple[float, float]], ranges: List[dict]) -> Dict[str, float]:
    """{range name: idle ms}: each gap between the device's busy spans goes
    to the innermost `annotate` range open at the gap's middle on any host
    thread (the one that started last), the rest to NO_RANGE. One sweep
    over the ranges, which nest on each thread."""
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    stacks: Dict[tuple, List[dict]] = collections.defaultdict(list)
    out: Dict[str, float] = collections.Counter()
    i = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        while i < len(ranges) and ranges[i]["ts"] <= mid:
            e = ranges[i]
            st = stacks[(e.get("pid"), e.get("tid"))]
            while st and st[-1]["ts"] + st[-1]["dur"] < e["ts"]:
                st.pop()
            st.append(e)
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1]["ts"] + st[-1]["dur"] < mid:
                st.pop()
            if st and (best is None or st[-1]["ts"] > best["ts"]):
                best = st[-1]
        out[best["name"] if best else NO_RANGE] += (b - a) / 1e3
    return dict(out)


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
      each range's ops launched (matched by correlation id), by stream;
    - `idle_by_range`: {name: idle ms}, each gap between the device's busy
      spans put down to the innermost range open at its middle on any host
      thread, the gaps outside every range to NO_RANGE.

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
    spans = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = sum(e - s for s, e in spans) / 1e3
    return {
        "trace": paths[-1], "wall_ms": wall_ms, "device_ms": sum(ms.values()),
        "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms if dev else None,
        "top_device": [(k, v, n[k]) for k, v in ms.most_common(top)],
        "top_host": [(k, v, host_n[k]) for k, v in host_ms.most_common(top)],
        "ranges": {k: (v, rng_n[k]) for k, v in rng_ms.items()},
        "streams": _streams(dev),
        "range_streams": _range_streams(events, dev),
        "idle_by_range": _idle_by_range(
            spans, [e for e in events if e.get("cat") == "user_annotation"]),
    }
