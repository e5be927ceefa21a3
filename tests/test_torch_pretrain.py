"""UNet pretraining (rovr_torch/train/pretrain_local.py) and K1's backward
(rovr_torch/ops/conv.py) against the JAX package, on the CPU at f32.

Tiny widths (UNet 8-64, a 2-stage LPIPS, 32^2 frames), the JAX package's
random init carried across by `pretrain_state_from_jax`, the same host
clips, and the JAX sample draws replayed (`split(rng, 4)`: clip, frame,
pair, coin). Tolerances: K1's vjp 1e-4 (f32 sums in another order); the
UNet's input and weight gradients 1e-4 relative / 1e-6 absolute; metrics
1e-4; updated parameters within 1e-5 on at least 99% of entries and
everywhere within 2*lr (Adam turns the sign of a near-zero gradient into a
+-lr step); the sampled batches bit for bit.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_overrides
from rovr_tpu.config import Config as JConfig
from rovr_tpu.ops.pallas import conv as pconv
from rovr_tpu.train import pretrain_local as jpl
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.ops import conv as tconv
from rovr_torch.train import pretrain_local as tpl
from rovr_torch.utils.checkpoint import CheckpointManager
from rovr_torch.utils.convert import module_params_from_jax, pretrain_state_from_jax

B, L, S, FRAME, P = 3, 3, 5, 32, 4
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs():
    c = JConfig()
    cj = c.replace(
        data=dataclasses.replace(c.data, frame_size=(FRAME, FRAME), vid_length=S),
        model=dataclasses.replace(c.model, **tiny_model_overrides()),
        pretrain=dataclasses.replace(c.pretrain, batch_size=B),
    )
    return cj, from_dict(dataclasses.asdict(cj))


_PAIR = {}


def _pair():
    if not _PAIR:
        cj, ct = _configs()
        mods_j = jpl.make_modules(cj, dtype=jnp.float32)
        state_j = jpl.init_state(cj, mods_j, jax.random.PRNGKey(0))
        clips = [tsynthetic.synthetic_batch(20 + j, S, FRAME, FRAME) for j in range(L)]
        video = np.stack([x[0] for x in clips])
        orig = np.stack([x[1] for x in clips])
        # pair indices up to S + 1: the gather clips them to S - 1
        positives = np.random.default_rng(1).integers(0, S + 2, (L, S, P, 2)).astype(np.int32)
        _PAIR.update(cj=cj, ct=ct, mods_j=mods_j, state_j=state_j,
                     mods_t=tpl.make_modules(ct, dtype=torch.float32, device="cpu"),
                     state_t=pretrain_state_from_jax(state_j), video=video, orig=orig,
                     positives=positives)
    return _PAIR


def _replayed(rng, n, positives):
    """sample_batch's jax.random draws as the port's BatchIndices."""
    kl, kf, kp, km = jax.random.split(rng, 4)
    t = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731
    idx = tpl.BatchIndices(t(jax.random.randint(kl, (n,), 0, L)),
                           t(jax.random.randint(kf, (n,), 2, S)))
    if positives is None:
        return idx
    return idx._replace(pi=t(jax.random.randint(kp, (n,), 0, P)),
                        use_pos=torch.from_numpy(np.array(jax.random.uniform(km, (n,)) < 0.5)))


def _bind(mods, state):
    for mod, params in ((mods.local_net, state.params), (mods.lpips, state.lpips_params)):
        mod.load_state_dict(params, strict=True, assign=True)
        mod.requires_grad_(False)


# ---------------------------------------------------------------- K1's backward


@pytest.mark.parametrize("shape, relu", [((2, 9, 7, 8, 12), True), ((2, 9, 7, 8, 12), False),
                                         ((1, 16, 8, 4, 4), True), ((3, 5, 11, 16, 24), True)])
def test_k1_vjp_matches_pallas_interpret(monkeypatch, shape, relu):
    """The port's backward (aten's conv gradient, the mask from the saved
    output) against the JAX custom_vjp of the Pallas op run with
    interpret=True; the backward never runs the plain forward again."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    plain_calls = []
    plain = tconv.fused_conv3x3_plain
    monkeypatch.setattr(tconv, "fused_conv3x3_plain",
                        lambda *a, **kw: plain_calls.append(1) or plain(*a, **kw))
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, bias))
    before = tconv.fused_conv3x3.backward_calls
    y = tconv.fused_conv3x3(xt, kt, bt, relu)
    y.backward(torch.from_numpy(g))
    assert tconv.fused_conv3x3.backward_calls == before + 1 and len(plain_calls) == 1
    y_j, vjp = jax.vjp(lambda a, c, d: pconv.fused_conv3x3(a, c, d, relu, True),
                       jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for got, want in zip((xt.grad, kt.grad, bt.grad), vjp(jnp.asarray(g))):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k1_backward_dtypes():
    """gx in x's dtype, gk in the kernel's, gb f32 from the masked g."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 6, 5, 8)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((3, 3, 8, 16)).astype(np.float32) * 0.1)
    y = tconv.fused_conv3x3_plain(x, k, torch.zeros(16), True)
    g = torch.ones_like(y)
    gx, gk, gb = tconv.fused_conv3x3_backward(x, k, y, g, True)
    assert (gx.dtype, gk.dtype, gb.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    assert tuple(gx.shape) == tuple(x.shape) and tuple(gk.shape) == (3, 3, 8, 16)
    assert torch.equal(gb, (y > 0).float().sum((0, 1, 2)))
    # at f32 it equals its plain twin (autograd of the plain conv, same mask)
    x32 = x.float()
    y32 = tconv.fused_conv3x3_plain(x32, k, torch.zeros(16), True)
    for got, want in zip(tconv.fused_conv3x3_backward(x32, k, y32, g.float(), True),
                         tconv.fused_conv3x3_backward_plain(x32, k, y32, g.float(), True)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_unet_gradients_match_jax_grad():
    """LocalNetUNet's input and weight gradients (K1's backward at conv3-5)
    against jax.grad of the flax UNet on the same weights."""
    p = _pair()
    rng = np.random.default_rng(5)
    tgt = rng.random((2, FRAME, FRAME, 3), np.float32)
    ctx = rng.random((2, 2, FRAME, FRAME, 3), np.float32)
    wts = rng.standard_normal((2, FRAME, FRAME, 3)).astype(np.float32)
    net_j = p["mods_j"].local_net

    def loss_j(params, t, c):
        return jnp.sum(net_j.apply({"params": params}, t, c) * wts)

    g_params, g_t, g_c = jax.grad(loss_j, argnums=(0, 1, 2))(
        p["state_j"].params, jnp.asarray(tgt), jnp.asarray(ctx))
    net = p["mods_t"].local_net
    net.load_state_dict({k: v.clone() for k, v in p["state_t"].params.items()}, assign=True)
    net.requires_grad_(True)
    try:
        tt, ct = (torch.from_numpy(a).requires_grad_() for a in (tgt, ctx))
        (net(tt, ct) * torch.from_numpy(wts)).sum().backward()
        want = module_params_from_jax(g_params)
        assert set(want) == {n for n, _ in net.named_parameters()}
        for n, prm in net.named_parameters():
            np.testing.assert_allclose(prm.grad.numpy(), want[n].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=n)
        for got, ref in ((tt.grad, g_t), (ct.grad, g_c)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    finally:
        net.requires_grad_(False)


# ---------------------------------------------------------------- sampling and loss


@pytest.mark.parametrize("with_pos, legacy", [(False, False), (False, True), (True, False),
                                               (True, True)])
def test_sample_batch_on_replayed_draws(with_pos, legacy):
    p = _pair()
    pos = p["positives"] if with_pos else None
    rng = jax.random.PRNGKey(9)
    want = jpl.sample_batch(rng, jnp.asarray(p["video"]), jnp.asarray(p["orig"]), 16, legacy,
                            None if pos is None else jnp.asarray(pos))
    got = tpl.gather_batch(_replayed(rng, 16, pos), torch.from_numpy(p["video"]),
                           torch.from_numpy(p["orig"]), legacy,
                           None if pos is None else torch.from_numpy(pos))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gen = torch.Generator().manual_seed(0)
    image, context, target = tpl.sample_batch(gen, torch.from_numpy(p["video"]),
                                              torch.from_numpy(p["orig"]), 7, legacy,
                                              None if pos is None else torch.from_numpy(pos))
    assert image.shape == target.shape == (7, FRAME, FRAME, 3)
    assert context.shape == (7, 2, FRAME, FRAME, 3)


@pytest.mark.parametrize("step", [0, 1000])
def test_loss_fn_matches_jax(step):
    p = _pair()
    rng = jax.random.PRNGKey(2)
    batch_j = jpl.sample_batch(rng, jnp.asarray(p["video"]), jnp.asarray(p["orig"]), B)
    _, want = jpl.loss_fn(p["state_j"].params, p["state_j"].lpips_params, p["mods_j"],
                          batch_j, jnp.int32(step))
    _bind(p["mods_t"], p["state_t"])
    total, got = tpl.loss_fn(p["mods_t"], tuple(torch.from_numpy(np.array(x)) for x in batch_j),
                             step)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL, err_msg=k)
    # f32 power: 0.9993 rounds to f32 first
    assert float(got["Loss/gamma"]) == pytest.approx(0.1 + 0.9 * 0.9993 ** step, rel=1e-5)


def test_train_step_matches_jax():
    """One step with the positives mix: metrics, updated UNet parameters and
    Adam moments as JAX's; LPIPS untouched; the input state unchanged."""
    p = _pair()
    rng = jax.random.PRNGKey(4)
    data_j = tuple(jnp.asarray(p[k]) for k in ("video", "orig", "positives"))
    new_j, metrics_j = jpl.train_step(p["state_j"], rng, p["mods_j"], data_j, B)
    data_t = tuple(torch.from_numpy(p[k]) for k in ("video", "orig", "positives"))
    before = {k: v.clone() for k, v in p["state_t"].params.items()}
    calls = tconv.fused_conv3x3.backward_calls
    new_t, metrics_t = tpl.train_step(p["state_t"], None, p["mods_t"], data_t, B,
                                      indices=_replayed(rng, B, p["positives"]))
    assert tconv.fused_conv3x3.backward_calls == calls + 3  # conv3, conv4, conv5
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), **TOL, err_msg=k)
    want = pretrain_state_from_jax(new_j)
    assert new_t.step == want.step == 1 and new_t.opt_state["step"] == 1
    diff = torch.cat([(new_t.params[k] - want.params[k]).abs().flatten() for k in want.params])
    lr = p["ct"].pretrain.lr
    assert float(diff.max()) <= 2 * lr
    assert float((diff <= 1e-5).float().mean()) >= 0.99
    assert max(float((new_t.params[k] - before[k]).abs().max()) for k in before) > 0
    for k in want.params:
        np.testing.assert_allclose(new_t.opt_state["exp_avg"][k].numpy(),
                                   want.opt_state["exp_avg"][k].numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    for k, v in p["state_t"].lpips_params.items():
        assert new_t.lpips_params[k] is v
    for k, v in before.items():
        assert torch.equal(p["state_t"].params[k], v)


# ---------------------------------------------------------------- the driver


def test_run_writes_metrics_strip_checkpoints_and_resumes(tmp_path):
    _, ct = _configs()
    cfg = ct.replace(
        run=dataclasses.replace(ct.run, run_dir=str(tmp_path / "a"), log_every=1),
        pretrain=dataclasses.replace(ct.pretrain, viz_every=1, checkpoint_every=1))
    calls = tconv.fused_conv3x3.backward_calls
    state = tpl.run(cfg, steps=2, device="cpu")
    assert state.step == 2 and tconv.fused_conv3x3.backward_calls == calls + 6
    (path,) = glob.glob(str(tmp_path / "a" / "local_net_pretrain" / "*"))
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    gammas = [r["value"] for r in recs if r["tag"] == "Loss/gamma"]
    np.testing.assert_allclose(gammas, [1.0, 0.1 + 0.9 * 0.9993], rtol=1e-6)
    assert all(np.isfinite(r["value"]) for r in recs)
    assert glob.glob(os.path.join(path, "images", "*.png")) or glob.glob(
        os.path.join(path, "events.out.tfevents*"))
    ck = os.path.join(path, "checkpoints")
    assert sorted(os.listdir(ck)) == ["0", "1"]
    restored = CheckpointManager(ck).restore(template=state)
    assert restored.step == 2
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v)
    for k, v in state.opt_state["exp_avg_sq"].items():
        assert torch.equal(restored.opt_state["exp_avg_sq"][k], v)
    resumed = tpl.run(cfg.replace(run=dataclasses.replace(
        cfg.run, run_dir=str(tmp_path / "b"), restore_from=ck)), steps=1, device="cpu")
    assert resumed.step == 3 and resumed.opt_state["step"] == 3
