"""Reading a torch.profiler Chrome trace: the benchmark's frozen copy of the
port's `rovr_torch.utils.profiling.analyze_trace` (busy time as the union
of the device's spans, device time by kernel, the device work launched
under each `record_function` range, matched by correlation id), plus the
breakdown of the longest idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # work on the device
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")          # host launches (correlation ids)
TOP = 10


def _union(spans) -> List[Tuple[float, float]]:
    """The union of (start, end) spans as disjoint sorted spans."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _range_device_ms(events: List[dict], dev: List[dict]) -> Dict[str, float]:
    """{range name: device ms} of the work launched from inside each range:
    a launch on the range's host thread within its span, matched to its
    device work by correlation id."""
    by_corr = collections.defaultdict(list)
    for e in dev:
        if "correlation" in e.get("args", {}):
            by_corr[e["args"]["correlation"]].append(e)
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[(e.get("pid"), e.get("tid"))].append((e["ts"], e["args"]["correlation"]))
    for v in launches.values():
        v.sort()
    out: Dict[str, float] = collections.Counter()
    for r in events:
        if r.get("cat") != "user_annotation":
            continue
        thread = launches.get((r.get("pid"), r.get("tid")), [])
        lo = bisect.bisect_left(thread, (r["ts"], -1))
        hi = bisect.bisect_right(thread, (r["ts"] + r["dur"], float("inf")))
        out[r["name"]] += sum(k["dur"] for _, c in thread[lo:hi] for k in by_corr.get(c, ())) / 1e3
    return dict(out)


def _idle_gaps(busy: List[Tuple[float, float]], host: List[dict]) -> List[Tuple[str, float]]:
    """Idle time between the device's busy spans, summed by the innermost
    host op running at each gap's middle (over every host thread, the op
    that started last); the longest first (seconds). One sweep over the
    host ops, which nest on each thread."""
    host = sorted(host, key=lambda e: e["ts"])
    stacks: Dict[tuple, List[dict]] = collections.defaultdict(list)
    by_name: Dict[str, float] = collections.Counter()
    i = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            e = host[i]
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
        by_name[best["name"] if best else "(no host op)"] += (b - a) / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]


def analyze(path: str) -> dict:
    """busy_s, device seconds by kernel name, device ms by range, and the
    breakdown ({"device_ops", "idle_gaps"}) of the trace at `path`."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError(f"{path} holds no device work: the profiler saw no kernel")
    kernels: Dict[str, float] = collections.Counter()
    for e in dev:
        kernels[e["name"]] += e["dur"] / 1e6
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    host = [e for e in events if e.get("cat") == "cpu_op"]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernel_s": dict(kernels),
        "range_ms": _range_device_ms(events, dev),
        "breakdown": {
            "device_ops": [[k, v] for k, v in kernels.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in _idle_gaps(busy, host)],
        },
    }
