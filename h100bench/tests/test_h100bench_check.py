"""The check that decides `correct`, driven through a whole run with the
harness's look for a card skipped (drive.run_cell on the CPU, the port in
float32 at test size): sound runs come out correct; the control (the
reference with fp8 products in the program's place) and every fault each
cell can have (faults.py) come out not correct under the cells' limits."""

import pytest
import torch

from conftest import control_config, tiny_cell
import check
import drive
import faults
import program

SEED = 2 ** 31 + 4242
CASES = [(k, p) for k in ("train", "serve") for p in ("canvas", "attention")]


def _run(c):
    return drive.run_cell(c, SEED, 0.5, False, "cpu", 0.0, dtype=torch.float32)


@pytest.mark.parametrize("kind,policy", CASES)
def test_a_sound_run_is_correct(kind, policy):
    res = _run(tiny_cell(kind, policy))
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {f"{kind}_frames_per_s", "setup_s"}


@pytest.mark.parametrize("kind,policy,fault", [
    (k, p, f) for k, p in CASES for f in (faults.TRAIN if k == "train" else faults.SERVE)])
def test_a_planted_fault_is_not_correct(kind, policy, fault, monkeypatch):
    c = tiny_cell(kind, policy)
    built, planted = drive.Setup.__init__, []

    def init(self, *a, **k):     # plant the fault once the run has built its modules
        built(self, *a, **k)
        planted.append(faults.planted(fault, kind, self.mods))
        planted[-1].__enter__()

    monkeypatch.setattr(drive.Setup, "__init__", init)
    try:
        res = _run(c)
    finally:
        for ctx in planted:
            ctx.__exit__(None, None, None)
    assert planted and not res["correct"], res["compared"]


@pytest.mark.parametrize("kind,policy", CASES)
def test_the_control_is_not_correct(kind, policy):
    """The reference with fp8 products in the program's place, at
    `control_config`'s size, fails the cell's limits."""
    c = tiny_cell(kind, policy)
    c["config"]["config"] = control_config(policy, kind)
    c["mix"]["box"] = [16, 24]
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32)
    s.seed(SEED)
    cfg, w = s.cfg_dict, s.weights
    if kind == "train":
        feed = s.pool[:c["mix"]["setup_units"]]
        with check.full_f32():
            recs = check.reference_train(cfg, w, feed, precision="fp8")
        numbers = check.compare_train(cfg, w, feed, recs)
    else:
        batches = []
        for item in s.pool[:c["mix"]["check_batches"]]:
            out = check.reference_serve(cfg, w, item["video"], "fp8")
            batches.append({"input": item["video"], **out})
        numbers = check.compare_serve(cfg, w, batches)
    assert not check.verdict(numbers, c["work"]["limits"]), numbers


@pytest.mark.cuda
def test_a_traced_tiny_cell_runs_on_the_card(cuda):
    """The traced path on the card at test size, kernels and launch check
    included (bf16, as the configuration states)."""
    c = tiny_cell("train", "attention")
    res = drive.run_cell(c, SEED, 0.5, True, cuda, 0.0)
    assert res["device"]["busy_s"] > 0 and res["attempted"] == 2 * c["mix"]["trace_units"]
    assert {"mfu.train", "idle_share.train", "k1_roofline.train",
            "attn_roofline.train"} <= set(res["metrics"])


def test_the_recorded_window_step_is_never_the_windows_first():
    steps = {drive.window_step(SEED + i) for i in range(64)}
    assert steps == {1, 2}


def test_a_fault_of_the_window_alone_is_caught_by_its_recorded_step():
    """`stale` leaves the set-up's three steps sound: only the window's
    recorded step, started from the program's own policies, reads it."""
    c = tiny_cell("train", "attention")
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32)
    with faults.planted("stale", "train", s.mods):
        res = drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, setup=s)
    s.seed(SEED)
    feed = s.pool[:c["mix"]["setup_units"]]
    with faults.planted("stale", "train", s.mods):
        _, records = drive.train_records(s, program.state(s.weights), len(feed))
    alone = check.compare_train(s.cfg_dict, s.weights, feed, records)
    limits = c["work"]["limits"]
    assert check.verdict(alone, limits), alone
    assert not res["correct"] and res["numbers"]["logp_gap"] > limits["logp_gap"], res["numbers"]
