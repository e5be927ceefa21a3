"""The work counters: each cell's stored count is a fresh count, the bounds
are chip_smoke.py's at the shapes PERF.md lists, and no share of a roofline
or a peak can pass 100% through the arithmetic alone."""

import json
import os

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH, ROOT
import readers
import work

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH_JSON = json.load(f)
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]


def _cell(name):
    w = next(x for x in BENCH_JSON["workloads"] if x["name"] == name)
    conf = next(c for c in BENCH_JSON["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        conf_file = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as f:
        kind = json.load(f)["kind"]
    with open(os.path.join(BENCH, "cells", f"{name}.json")) as f:
        return conf_file, kind, json.load(f)


@pytest.mark.parametrize("name", CELLS)
def test_stored_work_equals_a_fresh_count(name):
    conf_file, kind, stored = _cell(name)
    fresh = work.unit(conf_file["config"], kind, conf_file.get("reference", "episode"))
    assert {k: stored[k] for k in fresh} == fresh


def test_bounds_are_chip_smokes_at_perf_md_shapes():
    k1 = sum(work.conv_bound(8, h, w, ci, co)[0]
             for h, w, ci, co in ((64, 64, 128, 256), (32, 32, 256, 512), (64, 64, 512, 256)))
    assert round(k1, 4) == 0.1173
    got = [round(work.attention_bound_ms(512, 4, 256, 64, k), 4) for k in ("fwd", "dq", "dkv")]
    assert got == [0.0808, 0.1014, 0.1214]


def test_counted_operations_are_what_the_products_need():
    """conv_bound's and attention_cost's FLOPs are FlopCounterMode's count of
    the plain op, and their bytes each operand once: a share above 100%
    would then need a kernel faster than the chip's peak."""
    x = torch.empty(2, 16, 12, 10, device="meta")
    w = torch.empty(24, 16, 3, 3, device="meta")
    with FlopCounterMode(display=False) as c:
        F.conv2d(x, w, padding=1)
    assert work.conv_bound(2, 12, 10, 16, 24)[2] == c.get_total_flops()
    q = torch.empty(2, 3, 40, 8, device="meta")
    with FlopCounterMode(display=False) as c:
        torch.matmul(torch.softmax(torch.matmul(q, q.transpose(-1, -2)), -1), q)
    flops, nbytes = work.attention_cost(2, 3, 40, 40, 8)
    assert flops["fwd"] == c.get_total_flops()
    assert nbytes["fwd"] == 2 * 3 * 40 * 8 * 2 * 4 + 4 * 2 * 3 * 40   # q, k, v, o + f32 lse


def test_a_share_is_the_bound_over_the_time_unclamped():
    ctx = {"work": {"k1_bound_ms": 2.0, "flops": 989e12}, "units": 3, "window_s": 3.4,
           "timed_s": 2.0, "busy_s": 1.5,
           "kernel_s": {"void conv3x3_kernel<1>": 0.003, "other": 1.0},
           "range_ms": {}, "peak_mem_bytes": 0}
    assert readers.roofline(ctx, ("conv3x3_kernel",), "k1_bound_ms") == pytest.approx(200.0)
    # the wall time is the unprofiled units', not the profiled window's
    assert readers.mfu(ctx) == pytest.approx(150.0)
    assert readers.idle_share(ctx) == pytest.approx(25.0)
    assert readers.roofline(ctx, ("flash_fwd",), "k1_bound_ms") is None
    assert readers.roofline(ctx, ("conv3x3_kernel",), "attn_bound_ms") is None
    assert readers.range_ms(ctx, "rovr/episode_init") is None
    assert readers.peak_mem_gb(ctx) is None
