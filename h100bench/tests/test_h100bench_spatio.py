"""The configuration `config5_spatio`: the plain RAFT-small of
reference/raft.py against the port's `rovr_torch.models.raft.RAFTSmall` at
float32 on the benchmark's drawn weights, RAFT's work as the cell's file
keeps it, `phi_gap`, and the spatio reference (reference/spatio.py)
judging a tiny cell with spatio logged, as the cell's configuration has
it: correct as the port runs it, and failing a limit under `frozen` and
under the spatio faults planted here (RAFT at half its iterations; φ of
the corrupted clip taken for the reconstruction's). A configuration that
rewards spatio is refused.

Tolerances: the lookup's and the pyramid's f32 sums are short (1e-5); the
flow is 2 or 12 recurrent updates of f32 convs summed in another order,
held within 1e-4 of its largest value."""

import contextlib
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH, ROOT, tiny_config
import drive
import faults
import program
import traffic
import weights
import work
from reference import model as M
from reference import raft as R
from reference import spatio as SP
from rovr_torch.models import raft as T
from rovr_torch.train import rl

CELL = "config5_spatio.train"
SEED = 2 ** 32 + 2021
SIZE = 64

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)


def _port(iters: int, seed: int = SEED):
    """The port's RAFTSmall at f32 holding the benchmark's drawn weights."""
    m = T.RAFTSmall(iters=iters, dtype=torch.float32).requires_grad_(False)
    w = weights.draw({"raft": m}, seed, "cpu")["raft"]
    m.load_state_dict(w, strict=True)
    return m, w


def test_the_reference_reads_every_port_parameter_by_name():
    m, _ = _port(2)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == R.param_shapes()


def test_pyramid_and_lookup_match_the_port():
    g = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn(2, 7, 9, 16, generator=g) for _ in range(2))   # odd edges crop
    pt = T.correlation_pyramid(f1, f2)
    pr = R.pyramid(M.Precision("f32"), f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2))
    assert [tuple(x.shape[2:]) for x in pr] == [(7, 9), (3, 4), (1, 2), (0, 1)]
    for a, b in zip(pt, pr):
        assert torch.allclose(a.reshape(b.shape), b, rtol=1e-5, atol=1e-5)
    # coordinates inside, on and past every edge of each level, fractional
    coords = -6.0 + 20.0 * torch.rand(2, 7, 9, 2, generator=g)
    coords[0, 0, 0] = torch.tensor([-3.5, -3.5])
    coords[1, -1, -1] = torch.tensor([12.25, 9.75])
    coords[1, 0, -1] = torch.tensor([8.0, 0.0])                     # on the last column
    lt = T.lookup_corr(pt, coords)
    lr = R.lookup(pr, coords.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert lt.shape == lr.shape == (2, 7, 9, 4 * 49)
    assert torch.allclose(lt, lr, rtol=1e-5, atol=1e-5)
    assert lr.abs().min().item() == 0.0                              # some taps fell outside


@pytest.mark.parametrize("iters", [2, 12])
def test_a_pair_flows_as_the_port(iters):
    m, w = _port(iters)
    g = torch.Generator().manual_seed(iters)
    a = torch.rand(2, SIZE, SIZE, 3, generator=g)
    b = (torch.roll(a, 3, 2) + 0.02 * torch.randn(a.shape, generator=g)).clamp(0, 1)
    ft = m(a, b)
    fr = R.flow(M.Precision("f32"), w, a, b, iters)
    scale = fr.abs().max().item()
    assert ft.shape == fr.shape == (2, SIZE, SIZE, 2) and scale > 0
    assert (ft - fr).abs().max().item() <= 1e-4 * scale


def _cell_file():
    conf = next(c for c in B["configs"] if c["name"] == "config5_spatio")
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "cells", f"{CELL}.json")) as f:
        return cfg, json.load(f)


def test_raft_work_equals_a_fresh_count():
    """`extra_flops` is three passes of B * (S - 1) pairs, each the port's
    own RAFT counted on the meta device; the stored `raft_bound_ms` is
    that count at the bf16 peak (compute-bound at 256^2)."""
    conf, stored = _cell_file()
    cfg = conf["config"]
    assert conf["reference"] == "spatio" and cfg["rl"]["log_spatio"]
    m = T.RAFTSmall(dtype=torch.float32).to("meta")
    x = torch.empty(1, 256, 256, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        m(x, x)
    per_pair = counter.get_total_flops()
    n = cfg["rl"]["batch_size"] * (cfg["rl"]["vid_length"] - 1)
    assert R.flow_size(cfg) == 256 and n == 504
    assert SP.extra_flops(cfg, "train") == 3 * n * per_pair
    assert SP.extra_flops(cfg, "serve") == 0.0
    assert stored["raft_bound_ms"] == SP.raft_bound_ms(cfg)
    assert stored["raft_bound_ms"] == pytest.approx(3 * n * per_pair / work.PEAK_BF16_FLOPS * 1e3)
    assert stored["flops"] == work.flops(cfg, "train") + SP.extra_flops(cfg, "train")


def test_phi_gap_is_the_largest_relative_gap_of_a_mean_phi():
    def rec(prefix, spatio, phis):
        return {"metrics": {f"{prefix}spatio": spatio, "spatio_scale": 7.5,
                            **{f"{prefix}phi_{k}": v for k, v in zip(SP.PASSES, phis)}}}

    ref = [rec("", 1.0, (100.0, 200.0, 400.0)), rec("", -2.0, (10.0, 20.0, 40.0))]
    prog = [rec("Episode/", 1.0, (101.0, 200.0, 400.0)), rec("Episode/", 1.0, (10.0, 20.0, 39.0))]
    got = SP.extra_numbers(list(zip(prog, ref)))
    assert got == pytest.approx({"phi_gap": 0.025, "spatio_gap": 0.4})
    assert SP.extra_numbers(list(zip(ref, ref))) == {"phi_gap": 0.0, "spatio_gap": 0.0}


def test_a_rewarded_spatio_is_refused():
    cfg = tiny_config("attention")
    cfg["rl"]["use_spatio_reward"] = True
    with pytest.raises(ValueError, match="log_spatio"):
        SP.Ref(cfg, {})


def _tiny_cell() -> dict:
    """The cell as drive.load_cell gives it, at conftest's tiny attention
    configuration (32x32 frames: RAFT at 32^2, a pyramid of 4, 2, 1, 0)
    with spatio logged as the cell's configuration has it: the real cell's
    mix, metrics and limits."""
    cell = next(w for w in B["workloads"] if w["name"] == CELL)
    mix = traffic.load(cell["traffic"])
    mix["box"] = [8, 12]
    cfg = tiny_config("attention")
    cfg["rl"]["log_spatio"] = True
    e2e = [m for m in B["end_to_end"] if "workloads" not in m or CELL in m["workloads"]]
    return {"cell": cell, "config": {"config": cfg, "reference": "spatio"}, "mix": mix,
            "work": {**work.unit(cfg, "train", "spatio"), "limits": _cell_file()[1]["limits"]},
            "end_to_end": e2e,
            "per_layer": [m for m in B["per_layer"] if CELL in m.get("workloads", [])]}


@pytest.fixture(scope="module")
def setup():
    c = _tiny_cell()
    return c, drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32,
                          ref="spatio")


@contextlib.contextmanager
def _corrupted_as_recon():
    """The program takes φ of the corrupted clip where the reconstruction's
    belongs: spatio reads 0 whatever was reconstructed."""
    spatio = rl._spatio

    def wrong_clip(state, mods, cfg, recon, org_video, video):
        return spatio(state, mods, cfg, video, org_video, video)

    rl._spatio = wrong_clip
    try:
        yield
    finally:
        rl._spatio = spatio


@contextlib.contextmanager
def _half_iterations(raft):
    iters = raft.iters
    raft.iters = iters // 2
    try:
        yield
    finally:
        raft.iters = iters


def _run(c, s, fault=None):
    if fault == "frozen":
        ctx = faults.planted("frozen", "train", s.mods)
    elif fault == "half_iterations":
        ctx = _half_iterations(s.mods.raft)
    elif fault == "corrupted_as_recon":
        ctx = _corrupted_as_recon()
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        return drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, setup=s)


def test_a_spatio_cell_is_correct_and_compares_phi(setup):
    c, s = setup
    st = s.seed(SEED)
    assert list(s.weights) == list(program.FIRST_MODULES) + ["raft"]
    assert st.raft_params is s.weights["raft"] and s.extra_metrics == SP.EXTRA_METRICS
    res = _run(c, s)
    assert res["correct"], res["compared"]
    assert res["compared"]["phi_gap"]["value"] == res["numbers"]["phi_gap"] < 1e-5
    assert res["numbers"]["spatio_gap"] < 1e-3


@pytest.mark.parametrize("fault", ["frozen", "half_iterations", "corrupted_as_recon"])
def test_a_spatio_cell_catches_a_planted_fault(setup, fault):
    c, s = setup
    res = _run(c, s, fault)
    assert not res["correct"], res["compared"]
    if fault != "frozen":
        assert res["numbers"]["phi_gap"] > res["compared"]["phi_gap"]["limit"]
