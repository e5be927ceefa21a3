"""Per-rank work of the model-axis tests (tests/test_torch_{ring,tp,pp,ep}.py),
run in processes that `rovr_torch.parallel.launch.spawn` starts (gloo on
the CPU) on a (data, model) mesh. It imports no JAX, so each process starts
in seconds. The test process writes the cases (numpy inputs, port-layout
parameters) to a file; every rank runs each case on its data shard and
writes what it saw to <out>/rank<r>.pt; the test process compares with the
JAX package and with the single-process port."""

import os

import numpy as np
import torch

from rovr_torch.config import MeshConfig
from rovr_torch.models.moe import MoEFeedForward
from rovr_torch.models.attention import _attend, attend_plain
from rovr_torch.models.policy_attention import AttentionContextPolicy
from rovr_torch.parallel import collectives, tp
from rovr_torch.parallel.mesh import MODEL_AXIS, local_rows, make_mesh, replicate
from rovr_torch.parallel.pp import pipeline_layers
from rovr_torch.parallel.ring_attention import ring_self_attention_sharded
from rovr_torch.train import rl
from rovr_torch.utils.checkpoint import CheckpointManager


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _rows(mesh, x):
    return x[local_rows(mesh, x.shape[0])]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def ring_fn(mesh, case):
    """The JAX entry's global view and its gradients; `_attend` with the
    heads split over the axis; the refusal of an unsplittable length."""
    q, k, v = (_t(case[n], grad=True) for n in ("q", "k", "v"))
    out = ring_self_attention_sharded(mesh, q, k, v, MODEL_AXIS)
    (out * _t(case["w"])).sum().backward()
    local = [_rows(mesh, _t(case[n])) for n in ("q", "k", "v")]
    mine = [collectives.split(t, mesh, MODEL_AXIS, 1) for t in local]   # this rank's heads
    odd = torch.zeros(1, 1, 5 * mesh.model_size + 1, 8)
    return dict(out=out.detach(), grads=[t.grad for t in (q, k, v)],
                heads=_attend(*mine, impl="ring", mesh=mesh, seq_axis=MODEL_AXIS,
                              heads_split=True),
                heads_want=collectives.split(attend_plain(*local), mesh, MODEL_AXIS, 1),
                odd=_error(lambda: _attend(odd, odd, odd, "ring", mesh, MODEL_AXIS)))


def _dense(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_fn(mesh, case):
    """pipeline_layers of dense tanh layers: outputs at each microbatch
    request, the layers' gradients of sum(y^2) (this data shard's part)."""
    layers = [{k: _t(v, grad=True) for k, v in p.items()} for p in case["layers"]]
    x = _rows(mesh, _t(case["x"]))
    outs = {mb: pipeline_layers(_dense, layers, x, mesh, microbatches=mb).detach()
            for mb in case["microbatches"]}
    (pipeline_layers(_dense, layers, x, mesh, microbatches=0) ** 2).sum().backward()
    xb = _rows(mesh, _t(case["x"])).to(torch.bfloat16)
    mixed = pipeline_layers(
        lambda p, a: torch.tanh((a.to(torch.bfloat16) @ p["w"].to(torch.bfloat16)).float()
                                + p["b"]), layers, xb, mesh, microbatches=2)
    return dict(outs=outs, grads=[{k: v.grad for k, v in p.items()} for p in layers],
                mixed=mixed.detach(), mixed_dtype=str(mixed.dtype))


def _load(module, mesh, params):
    """Port-layout parameters of the whole module, cut to this rank's parts."""
    specs = tp.param_specs(module)
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    module.load_state_dict({k: v.chunk(mesh.model_size, specs[k])[mesh.model_rank].clone()
                            if k in specs else v for k, v in sd.items()}, strict=True)
    return module


def policy_pp(mesh, case):
    pol = _load(AttentionContextPolicy(**case["kw"], mesh=mesh), mesh, case["params"])
    with torch.no_grad():
        return dict(logits=pol.masked_logits(_rows(mesh, _t(case["feats"])),
                                             _rows(mesh, _t(case["tgt"]))))


def moe(mesh, case):
    """The expert-parallel MoE on this data shard: output, moe_aux, and the
    gradients of sum(y * w) (this shard's part; the experts this rank owns)."""
    m = _load(MoEFeedForward(**case["kw"], mesh=mesh), mesh, case["params"])
    x = _rows(mesh, _t(case["x"])).requires_grad_()
    y = m(x)
    (y * _rows(mesh, _t(case["w"]))).sum().backward()
    return dict(y=y.detach(), aux=float(m.moe_aux), gx=x.grad,
                grads={k: p.grad for k, p in m.named_parameters()},
                specs=tp.param_specs(m))


def train(mesh, case):
    """The sharded (or tensor-parallel) train step on the global batch, its
    state gathered whole; with `checkpoint`, the state saved and restored
    through CheckpointManager(mesh=, shardings=)."""
    cfg = case["cfg"]
    mods = rl.make_modules(cfg, dtype=torch.float32, device="cpu", mesh=mesh,
                           tensor_parallel=case.get("tp", False))
    state = replicate(mesh, rl.init_state(cfg, mods, seed=0))
    make = tp.make_tp_train_step if case.get("tp") else rl.make_sharded_train_step
    step = make(mesh, mods, cfg)
    before = dict(collectives.CALLS)
    new, metrics, recon = step(state, case["video"], case["org"], gumbel=case["gumbel"],
                               masks=case["masks"])
    calls = {k: v - before.get(k, 0) for k, v in collectives.CALLS.items()
             if v - before.get(k, 0)}
    shardings = tp.state_shardings(mods)
    whole = tp.gather_state(new, shardings, mesh)
    out = dict(metrics={k: float(v) for k, v in metrics.items()}, recon=recon,
               rows=local_rows(mesh, case["video"].shape[0]), calls=calls,
               state={f: getattr(whole, f) for f in (
                   "actor2_params", "critic2_params", "actor2_opt", "critic2_opt")},
               step=new.step, shardings=shardings)
    if case.get("checkpoint"):
        mgr = CheckpointManager(case["checkpoint"], mesh=mesh, shardings=shardings)
        mgr.save(0, new, force=True)
        mgr.wait()
        restored = mgr.restore(template=rl.init_state(cfg, mods, seed=1))
        mgr.close()
        out["restored_equal"] = all(
            torch.equal(getattr(restored, f)[k], getattr(new, f)[k])
            for f in ("actor2_params", "critic2_params") for k in getattr(new, f)) and all(
            torch.equal(restored.actor2_opt[m][k], new.actor2_opt[m][k])
            for m in ("exp_avg", "exp_avg_sq") for k in new.actor2_opt[m])
        out["checkpoint_files"] = sorted(os.listdir(case["checkpoint"]))
    return out


CASES = {"ring_fn": ring_fn, "pipeline_fn": pipeline_fn, "policy_pp": policy_pp,
         "moe": moe, "train": train}


def run_cases(_default_mesh, inputs_path: str, out_dir: str, dp: int, mp: int) -> None:
    torch.manual_seed(0)
    mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
    inputs = torch.load(inputs_path, weights_only=False)
    res = {"grid": (mesh.rank, mesh.model_rank)}
    for name, case in inputs.items():
        res[name] = CASES[case["kind"]](mesh, case)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank * mp + mesh.model_rank}.pt"))


def spawn_cases(cases: dict, tmp, dp: int, mp: int) -> list:
    """Run `cases` on a dp x mp gloo mesh of dp*mp processes (a file store
    under `tmp`); returns each rank's results, in rank order (r = data
    index * mp + model index)."""
    from rovr_torch.parallel import launch

    os.makedirs(tmp, exist_ok=True)
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save(cases, inputs)
    launch.spawn(run_cases, dp * mp, "cpu", args=(inputs, str(tmp), dp, mp),
                 init_method=f"file://{os.path.join(tmp, 'store')}", threads=1)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(dp * mp)]


def assert_step_matches(got: dict, ref: dict, cfg) -> None:
    """A rank's sharded step (its state gathered whole) against the
    single-process step on the global batch, with
    tests/test_torch_data_parallel.py's tolerances: metrics and the rank's
    reconstructions 1e-4; the updated actor and critic within 1e-5 on at
    least 99% of entries and everywhere within 2*lr*n_updates; the Adam
    counts equal; each leaf's Adam first moment (0.1 * g after one epoch)
    within 1e-3 of its network's largest first moment + 1e-6. Adam's first
    step is lr * g / (|g| + eps), so the parameters see only sign(g): the
    moments are what catch a gradient off by a positive factor (one summed
    over the model axis, say)."""
    assert got["step"] == ref["state"].step == 1
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["recon"].numpy(), ref["recon"][got["rows"]].numpy(),
                               rtol=1e-4, atol=1e-4)
    bound = 2 * cfg.rl.actor_lr * cfg.rl.n_updates_per_ppo
    for field in ("actor2", "critic2"):
        mine, want = got["state"][f"{field}_params"], getattr(ref["state"], f"{field}_params")
        before = getattr(ref["before"], f"{field}_params")
        assert set(mine) == set(want) and all(mine[k].shape == want[k].shape for k in want)
        assert max(float((mine[k] - before[k]).abs().max()) for k in mine) > 0, field
        diff = torch.cat([(mine[k] - want[k]).abs().flatten() for k in want])
        assert float(diff.max()) <= bound, (field, float(diff.max()))
        assert float((diff <= 1e-5).float().mean()) >= 0.99, field
        opt, opt_ref = got["state"][f"{field}_opt"], getattr(ref["state"], f"{field}_opt")
        assert opt["step"] == opt_ref["step"] == cfg.rl.n_updates_per_ppo
        top = max(float(v.abs().max()) for v in opt_ref["exp_avg"].values())
        for k in want:
            err = float((opt["exp_avg"][k] - opt_ref["exp_avg"][k]).abs().max())
            assert err <= 1e-3 * top + 1e-6, (field, k, err, top)


def single_step(cfg, case) -> dict:
    """The single-process port's train_step on the global batch (the
    reference of every sharded step)."""
    mods = rl.make_modules(cfg, dtype=torch.float32, device="cpu")
    state = rl.init_state(cfg, mods, seed=0)
    new, metrics, recon = rl.train_step(state, mods, cfg, case["video"], case["org"],
                                        gumbel=case["gumbel"], masks=case["masks"])
    return dict(state=new, before=state, metrics=metrics, recon=recon)
