"""The port's profiling and debug utilities (rovr_torch/utils/profiling.py,
utils/debug.py) on the CPU: `trace` writes a Chrome trace that
`analyze_trace` reads back (host ops, annotated ranges, no device work so
no idle share), the union of overlapping device spans, the idle gaps put
down to the innermost range; `annotate` off (no range, nothing recorded),
recorded (nesting, parent and root, a body that raises, a stack per
thread) and under the profiler; `checked` raising on the first non-finite
output and naming it; anomaly mode on and off.
"""

import json
import os
import threading
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
    assert report["idle_by_range"] == {}
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


def test_idle_gaps_go_to_the_innermost_range_open_at_their_middle(tmp_path):
    """Each gap between the device's busy spans goes to the innermost range
    open at its middle, over every host thread (the one that started last);
    a gap outside every range to "(no range)"."""
    def rng(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 9, "tid": tid,
                "ts": ts, "dur": dur}

    def kernel(ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": ts,
                "dur": dur}

    ev = [rng("rovr/train_step", 0, 100), rng("rovr/rollout", 10, 40),
          rng("rovr/rollout/unet", 12, 10), rng("prefetch", 60, 30, tid=2),
          rng("prefetch/decode", 65, 5, tid=2),
          kernel(0, 5), kernel(20, 5), kernel(50, 5), kernel(120, 10), kernel(150, 10)]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    r = profiling.analyze_trace(str(tmp_path))
    # gaps: [5, 20) mid 12.5 -> unet; [25, 50) mid 37.5 -> rollout (unet has
    # ended); [55, 120) mid 87.5 -> prefetch, on the other thread, which
    # started after train_step; [130, 150) mid 140 -> no range
    assert r["idle_by_range"] == {
        "rovr/rollout/unet": pytest.approx(0.015), "rovr/rollout": pytest.approx(0.025),
        "prefetch": pytest.approx(0.065), profiling.NO_RANGE: pytest.approx(0.02)}
    assert sum(r["idle_by_range"].values()) == pytest.approx(r["wall_ms"] - r["busy_ms"])


def test_annotate_off_opens_no_range_and_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))

    @profiling.annotate("rovr/decorated")
    def f(x):
        return x + 1

    with profiling.annotate("rovr/off"):
        assert f(1) == 2
    with pytest.raises(KeyError):
        with profiling.annotate("rovr/raises"):
            raise KeyError("x")
    assert opened == [] and profiling._RECORDING is None
    with profiling.recording() as spans:
        pass
    assert spans == []


def test_recorded_spans_nest_with_parent_and_root():
    @profiling.annotate("unit/leaf")
    def leaf():
        return 3

    with profiling.recording() as spans:
        with profiling.annotate("unit"):
            with profiling.annotate("unit/a"):
                assert leaf() == 3
            with pytest.raises(ValueError):
                with profiling.annotate("unit/b"):
                    raise ValueError("closes the span")
            leaf()
        with profiling.annotate("unit"):
            pass
    got = [(s.name, s.root, s.parent) for s in spans]
    assert got == [("unit", 0, None), ("unit/a", 0, 0), ("unit/leaf", 0, 1),
                   ("unit/b", 0, 0), ("unit/leaf", 0, 0), ("unit", 5, None)]
    assert all(s.t1_ns is not None and s.t1_ns >= s.t0_ns for s in spans)
    assert spans[0].t0_ns <= spans[1].t0_ns and spans[1].t1_ns <= spans[0].t1_ns
    assert spans[3].ms >= 0 and spans[4].t0_ns >= spans[3].t1_ns
    with profiling.annotate("after"):
        pass
    assert len(spans) == 6 and profiling._RECORDING is None


def test_recorded_spans_keep_a_stack_per_thread():
    """Two threads open spans at once (a barrier holds each inside its
    outer span): each thread's inner span has its own outer span as parent
    and root."""
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.annotate(f"{tag}/outer"):
            barrier.wait()
            with profiling.annotate(f"{tag}/inner"):
                barrier.wait()

    with profiling.recording() as spans:
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: i for i, s in enumerate(spans)}
    assert len(spans) == 4 and len(by_name) == 4
    for tag in ("a", "b"):
        outer, inner = by_name[f"{tag}/outer"], by_name[f"{tag}/inner"]
        assert spans[outer].root == outer and spans[outer].parent is None
        assert spans[inner].root == outer and spans[inner].parent == outer


def test_annotate_under_the_profiler_lands_as_a_range(tmp_path):
    @profiling.annotate("rovr/decorated")
    def f(a):
        return torch.tanh(a @ a)

    a = torch.randn(32, 32)
    with profiling.recording() as spans, profiling.trace(str(tmp_path)):
        with profiling.annotate("rovr/outer"):
            f(a)
            f(a)
    r = profiling.analyze_trace(str(tmp_path))
    assert r["ranges"]["rovr/outer"][1] == 1 and r["ranges"]["rovr/decorated"][1] == 2
    assert r["ranges"]["rovr/outer"][0] >= r["ranges"]["rovr/decorated"][0]
    assert [s.name for s in spans] == ["rovr/outer", "rovr/decorated", "rovr/decorated"]


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
