"""The port's profiling and debug utilities (rovr_torch/utils/profiling.py,
utils/debug.py) on the CPU: `trace` writes a Chrome trace that
`analyze_trace` reads back (host ops, annotated ranges, no device work so
no idle share), the union of overlapping device spans, `StepTimer`,
`device_memory_stats` without a card; `checked` raising on the first
non-finite output and naming it; anomaly mode on and off.
"""

import json
import os
from typing import NamedTuple

import pytest
import torch

from rovr_torch.utils import debug, profiling


def test_trace_and_analyze_on_a_cpu_op(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("rovr/matmul"):
            for _ in range(3):
                a = torch.tanh(a @ a)
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    report = profiling.analyze_trace(str(tmp_path))
    host = {name: (ms, n) for name, ms, n in report["top_host"]}
    assert host["aten::mm"][1] == 3 and host["aten::tanh"][1] == 3
    assert report["ranges"]["rovr/matmul"][1] == 1
    assert report["ranges"]["rovr/matmul"][0] >= host["aten::mm"][0]
    assert report["device_ms"] == report["busy_ms"] == 0 and report["idle_share"] is None
    text = profiling.format_trace_report(report)
    assert "not measured" in text and "rovr/matmul" in text
    with pytest.raises(FileNotFoundError):
        profiling.analyze_trace(str(tmp_path / "empty"))


def test_analyze_counts_overlapping_device_spans_once(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "launch", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 40},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30, "dur": 40},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "rovr/step", "ts": 10, "dur": 60},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 80, "dur": 20}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    r = profiling.analyze_trace(str(tmp_path))
    assert r["wall_ms"] == pytest.approx(0.1)
    assert r["device_ms"] == pytest.approx(0.1)       # 40 + 40 + 20 us
    assert r["busy_ms"] == pytest.approx(0.08)        # [10, 70) and [80, 100)
    assert r["idle_share"] == pytest.approx(0.2)
    assert r["top_device"][0] == ("k", pytest.approx(0.06), 2)


def test_analyze_attributes_each_ranges_device_work_to_its_streams(tmp_path):
    """A range's device work is what the launches on its host thread within
    its span started (matched by correlation id), on whatever stream it
    ran; the device's time is split by stream too, each stream with its
    window and the share of it in which other streams ran."""
    def launch(ts, corr, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9,
                "tid": tid, "ts": ts, "dur": 2, "args": {"correlation": corr}}

    def kernel(ts, dur, stream, corr):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": stream,
                "ts": ts, "dur": dur, "args": {"stream": stream, "correlation": corr}}

    ev = [{"ph": "X", "cat": "user_annotation", "name": "rovr/episode_init", "pid": 9,
           "tid": 1, "ts": 0, "dur": 10},
          launch(1, 1), launch(5, 2), launch(12, 3), launch(6, 4, tid=2),
          kernel(20, 30, 13, 1), kernel(50, 10, 13, 2), kernel(30, 40, 7, 3),
          kernel(40, 5, 7, 4)]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    r = profiling.analyze_trace(str(tmp_path))
    assert r["range_streams"] == {"rovr/episode_init": {13: [pytest.approx(0.04), 2]}}
    assert {k: v["ms"] for k, v in r["streams"].items()} == {
        13: pytest.approx(0.04), 7: pytest.approx(0.045)}
    # stream 13 spans [20, 60); stream 7 ran in [30, 60) of it
    assert r["streams"][13]["window_ms"] == pytest.approx(0.04)
    assert r["streams"][13]["others_busy_share"] == pytest.approx(0.75)
    # stream 7 spans [30, 70); stream 13 ran in [30, 60) of it
    assert r["streams"][7]["others_busy_share"] == pytest.approx(0.75)
    assert r["device_ms"] == pytest.approx(0.085)
    assert r["busy_ms"] == pytest.approx(0.05)        # [20, 70)
    assert "device by stream" in profiling.format_trace_report(r)


def test_step_timer_and_memory_stats():
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        with timer.step():
            timer.sync({"out": (torch.ones(2),)})
    s = timer.summary()
    assert s["steps"] == 2.0 and 0 <= s["p50_s"] <= s["max_s"]
    assert profiling.device_memory_stats() == {}


class Out(NamedTuple):
    loss: torch.Tensor
    count: torch.Tensor


def test_checked_raises_on_the_first_non_finite_output():
    def step(x):
        return {"a": Out(x.sum(), torch.tensor(3)), "b": [x, x / x]}

    f = debug.checked(step)
    assert f(torch.ones(3))["a"].loss == 3
    with pytest.raises(FloatingPointError, match=r"step: output\['b'\]\[1\] has 2 "):
        f(torch.tensor([0.0, 1.0, 0.0]))
    with pytest.raises(FloatingPointError, match=r"output\['a'\]\.loss has 1 "):
        f(torch.tensor([float("inf"), 1.0]))


def test_anomaly_detection_toggles():
    try:
        debug.enable_anomaly_detection()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).backward()
    finally:
        debug.disable_anomaly_detection()
    assert not torch.is_anomaly_enabled()
