"""What a configuration brings to the harness by its files alone: every
module the port builds drawn and put in its state field, and a reference
module of its own, named by the configuration file's "reference" key, with
its policies, further numbers and further work. The existing
configurations' weights stay what they were: a digest of their draw at
test size, taken before the harness drew more than its five fixed modules,
is held here."""

import hashlib
import sys
import types

import pytest
import torch

from conftest import tiny_cell, tiny_config
import check
import drive
import faults
import program
import weights
import work
from reference import episode

SEED = 2 ** 31 + 4242
DIGESTS = {"canvas": "fe1767eb57ac5256d5b9c7cff1002a74",
           "attention": "1cadd03f577864ccbd78decad099f448"}


def _digest(w) -> str:
    h = hashlib.sha256()
    for mod, tree in w.items():
        for k, v in tree.items():
            h.update(f"{mod}.{k}{tuple(v.shape)}".encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("policy", ["canvas", "attention"])
def test_the_existing_configurations_draw_their_weights_as_before(policy):
    mods = program.modules(program.config(tiny_config(policy)), "cpu", torch.float32)
    w = weights.draw(program.module_dict(mods), SEED, "cpu")
    assert list(w) == list(program.FIRST_MODULES)
    assert _digest(w) == DIGESTS[policy]
    st = program.state(w)
    for n in program.FIRST_MODULES:
        assert getattr(st, f"{n}_params") is w[n]
    assert st.raft_params is None and st.actor1_opt is None and st.step == 0
    for n in ("actor2", "critic2"):
        opt = getattr(st, f"{n}_opt")
        assert opt["step"] == 0 and set(opt["exp_avg"]) == set(w[n])


def _spatio_cell() -> dict:
    c = tiny_cell("train", "attention")
    c["config"]["config"]["rl"]["log_spatio"] = True
    return c


def test_a_log_spatio_configuration_draws_raft_and_is_correct():
    """RAFT is drawn after the five modules and sits in `raft_params`; the
    recorded train steps run through it, and since `log_spatio` leaves the
    rewards alone the default reference judges them correct."""
    c = _spatio_cell()
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32)
    st = s.seed(SEED)
    assert list(s.weights) == list(program.FIRST_MODULES) + ["raft"]
    assert st.raft_params is s.weights["raft"] and len(st.raft_params) > 0
    assert s.policies == ("actor2", "critic2")
    res = drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, setup=s)
    assert res["correct"], res["compared"]


def test_a_log_spatio_configuration_catches_a_planted_fault():
    c = _spatio_cell()
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32)
    with faults.planted("frozen", "train", s.mods):
        res = drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, setup=s)
    assert not res["correct"], res["compared"]


class _StubRef(episode.Ref):
    """The default reference, counting the models made. It trains the
    actor alone (its POLICIES): the critic steps from a fresh Adam state."""

    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _StubRef.made.append(self)

    def ppo(self, traj, gumbel, opt):
        return super().ppo(traj, gumbel, {"critic2": episode.adam_state(self.w["critic2"]),
                                          **opt})


def _mse_gap(steps):
    return {"mse_gap": max(abs(p["metrics"]["Episode/mse_loss"] - r["metrics"]["mse_loss"])
                           for p, r in steps)}


STUB_FLOPS = 1.0e9


@pytest.fixture
def stub(monkeypatch):
    """A reference module `reference.stub_h100bench_test`, as a file there
    would be."""
    mod = types.ModuleType("reference.stub_h100bench_test")
    mod.Ref, mod.adam_state = _StubRef, episode.adam_state
    mod.POLICIES = ("actor2",)
    mod.EXTRA_METRICS = ("Episode/mse_loss",)
    mod.extra_numbers = _mse_gap
    mod.extra_flops = lambda cfg, kind: STUB_FLOPS
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    _StubRef.made.clear()
    return mod.__name__.split(".")[1]


def test_a_configurations_reference_judges_its_train_steps(stub):
    c = tiny_cell("train", "attention")
    c["config"]["reference"] = stub
    c["work"]["limits"]["mse_gap"] = 1e-3
    detail = {}
    res = drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, dtype=torch.float32, detail=detail)
    assert len(_StubRef.made) == 2           # the three set-up steps' model, the window's
    assert res["compared"]["mse_gap"] == {"value": res["numbers"]["mse_gap"], "limit": 1e-3}
    assert res["numbers"]["mse_gap"] < 1e-5
    assert "actor2.update" in detail and "critic2.update" not in detail


def test_a_configurations_reference_judges_its_served_batches(stub):
    c = tiny_cell("serve", "canvas")
    c["config"]["reference"] = stub
    res = drive.run_cell(c, SEED, 0.0, False, "cpu", 0.0, dtype=torch.float32)
    assert res["correct"] and len(_StubRef.made) == 1, res["compared"]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_configurations_reference_adds_its_work(stub, kind):
    cfg = tiny_config("canvas")
    assert work.flops(cfg, kind, stub) == work.flops(cfg, kind) + STUB_FLOPS
    assert check.policies(stub) == ("actor2",) and check.policies() == ("actor2", "critic2")
