"""The imitation warm start (rovr_torch/train/imitation.py) against the JAX
package, on the CPU at f32.

Tiny widths (the tiny backbone, feature 64, a 96^2 canvas of 3 x 2 tiles,
the attention policy at hidden 32, 2 heads, depth 2, 2 patch tokens over a
2 x 2 spatially pooled backbone, as the pipeline pools), the JAX package's
random init carried across by `imitation_state_from_jax`, the same clip
and teacher tables. Tolerances: the loss, top-2 accuracy and exposure 1e-4;
gradients 1e-4 relative / 1e-5 absolute (the f32 trunk's sums in another
order); updated parameters within 1e-5 on at least 99% of entries and
everywhere within 2*lr; the frozen backbone bit for bit.
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
from rovr_tpu.train import imitation as jim
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.train import imitation as tim
from rovr_torch.utils.convert import imitation_state_from_jax, module_params_from_jax

S, FRAME = 6, 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(policy, loss_mode="bce", train_vp=True):
    c = JConfig()
    attn = policy == "attention"
    cj = c.replace(
        data=dataclasses.replace(c.data, frame_size=(FRAME, FRAME), vid_length=S),
        model=dataclasses.replace(
            c.model, **tiny_model_overrides(), pn2_num_frames=S, feature_dim=64,
            canvas_size=96, canvas_tile=32, canvas_tiles_per_row=3, attn_hidden_dim=32,
            attn_heads=2, attn_depth=2, attn_patch_tokens=2,
            backbone_spatial_pool=2 if attn else 1),
        rl=dataclasses.replace(c.rl, context_policy=policy),
        imitation=dataclasses.replace(c.imitation, loss_mode=loss_mode, train_vp=train_vp),
    )
    return cj, from_dict(dataclasses.asdict(cj))


_PAIRS = {}


def _pair(policy, loss_mode="bce", train_vp=True):
    key = (policy, loss_mode, train_vp)
    if key not in _PAIRS:
        cj, ct = _configs(policy, loss_mode, train_vp)
        mods_j = jim.make_modules(cj, dtype=jnp.float32)
        state_j = jim.init_state(cj, mods_j, jax.random.PRNGKey(0))
        rng = np.random.default_rng(3)
        video = tsynthetic.synthetic_batch(4, S, FRAME, FRAME)[0]
        _PAIRS[key] = dict(
            cj=cj, ct=ct, mods_j=mods_j, state_j=state_j,
            mods_t=tim.make_modules(ct, dtype=torch.float32, device="cpu"),
            state_t=imitation_state_from_jax(state_j, train_vp),
            video=video, positives=rng.integers(0, S, (S, 5, 2)).astype(np.int32),
            negatives=rng.integers(0, S, (S, 2, 2)).astype(np.int32),
            masks=(rng.random((S, FRAME, FRAME, 3)) < 0.7).astype(np.float32))
    return _PAIRS[key]


def _batch_j(p):
    return tuple(jnp.asarray(p[k]) for k in ("video", "positives", "negatives", "masks"))


def _batch_t(p):
    return tuple(torch.from_numpy(p[k]) for k in ("video", "positives", "negatives", "masks"))


@pytest.mark.parametrize("policy, loss_mode", [("canvas", "bce"), ("canvas", "pair_ce"),
                                               ("attention", "bce"),
                                               ("attention", "pair_ce")])
def test_imitation_loss_and_gradients_match_jax(policy, loss_mode):
    p = _pair(policy, loss_mode)
    video, pos, neg, masks = _batch_j(p)
    grad_fn = jax.jit(jax.value_and_grad(jim.imitation_loss, argnums=(0, 1), has_aux=True),
                      static_argnums=(2,))
    (loss_j, metrics_j), (g_pn2, g_vp) = grad_fn(
        p["state_j"].pn2_params, p["state_j"].vp_params, p["mods_j"], video, pos, neg,
        masks=masks)
    named = tim._bind_trainable(p["mods_t"], p["state_t"])
    try:
        loss, metrics = tim.imitation_loss(p["mods_t"], *_batch_t(p)[:3],
                                           masks=_batch_t(p)[3])
        loss.backward()
    finally:
        p["mods_t"].pn2.requires_grad_(False)
        p["mods_t"].vp.requires_grad_(False)
    assert set(metrics) == set(metrics_j) == {"Loss/expert_loss", "Imitation/top2_acc",
                                              "Imitation/exposure"}
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4, atol=1e-4)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    want = {**{f"pn2.{k}": v for k, v in module_params_from_jax(g_pn2).items()},
            **{f"vp.{k}": v for k, v in module_params_from_jax(g_vp).items()}}
    names = {n for n, _ in named}
    assert names == {k for k in want if not k.startswith("vp.backbone.")}
    assert all(float(want[k].abs().max()) == 0 for k in want if k.startswith("vp.backbone."))
    for n, prm in named:
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("policy, loss_mode, train_vp", [("attention", "pair_ce", True),
                                                         ("canvas", "bce", True),
                                                         ("canvas", "bce", False)])
def test_train_step_matches_jax(policy, loss_mode, train_vp):
    """One Adam step as JAX's optax.multi_transform: π₂ (and the heads with
    train_vp) move as JAX's; the backbone (and the heads without train_vp)
    stay bit for bit and carry no Adam state."""
    p = _pair(policy, loss_mode, train_vp)
    new_j, metrics_j = jim.train_step(p["state_j"], _batch_j(p), p["mods_j"])
    new_t, metrics_t = tim.train_step(p["state_t"], _batch_t(p), p["mods_t"])
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert new_t.step == int(new_j.step) == 1 and new_t.opt_state["step"] == 1
    lr = p["ct"].imitation.lr
    for field in ("pn2_params", "vp_params"):
        want = module_params_from_jax(getattr(new_j, field))
        got, before = getattr(new_t, field), getattr(p["state_t"], field)
        assert set(got) == set(want)
        trained = [k for k in got if field == "pn2_params"
                   or (train_vp and not k.startswith("backbone."))]
        frozen = [k for k in got if k not in trained]
        for k in frozen:
            assert got[k] is before[k] and torch.equal(got[k], want[k]), k
        if not trained:
            continue
        diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in trained])
        assert float(diff.max()) <= 2 * lr, field
        assert float((diff <= 1e-5).float().mean()) >= 0.99, field
        assert max(float((got[k] - before[k]).abs().max()) for k in trained) > 0, field
    prefixes = {k.split(".")[0] + ("." + k.split(".")[1] if k.startswith("vp.") else "")
                for k in new_t.opt_state["exp_avg"]}
    assert prefixes == ({"pn2", "vp.feat_head", "vp.tile_head"} if train_vp else {"pn2"})


def test_helpers_match_jax():
    """preprocess_frames (shrinking 256 -> 224 antialiased, growing 160 ->
    224 plain), multi_hot and bce_with_logits."""
    rng = np.random.default_rng(0)
    for size in (256, 160):
        v = rng.random((3, size, size, 3), np.float32)
        got = tim.preprocess_frames(torch.from_numpy(v)).numpy()
        want = np.asarray(jim.preprocess_frames(jnp.asarray(v)))
        assert got.shape == want.shape == (1, 3, 224, 224, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pairs = rng.integers(0, 7, (9, 2)).astype(np.int32)
    np.testing.assert_array_equal(tim.multi_hot(torch.from_numpy(pairs), 7).numpy(),
                                  np.asarray(jim.multi_hot(jnp.asarray(pairs), 7)))
    logits = rng.standard_normal((9, 7)).astype(np.float32) * 5
    tgt = np.array(jim.multi_hot(jnp.asarray(pairs), 7))
    np.testing.assert_allclose(
        float(tim.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(tgt))),
        float(jim.bce_with_logits(jnp.asarray(logits), jnp.asarray(tgt))), rtol=1e-6)


def test_top2_ties_go_to_the_lower_index():
    """An all-equal row of logits picks frames (0, 1), or (1, 2) when the
    target's own zeroed logit ... is tied too: lax.top_k's order."""
    p = _pair("canvas")
    logits = torch.zeros(2, 4)
    idx = torch.sort(logits, dim=1, descending=True, stable=True)[1][:, :2]
    assert idx.tolist() == [[0, 1], [0, 1]]
    _, top2 = jax.lax.top_k(jnp.zeros((2, 4)), 2)
    assert np.asarray(top2).tolist() == idx.tolist()
    assert p["mods_t"].pn2.num_frames == S


def _run_cfg(ct, tmp_path, scheme, frame, policy):
    c = ct.replace(
        data=dataclasses.replace(ct.data, frame_size=(frame, frame), synthetic_scheme=scheme,
                                 synthetic_overlap_free=scheme == "raster"),
        model=dataclasses.replace(ct.model, pn2_num_frames=20, canvas_size=160,
                                  canvas_tiles_per_row=5, backbone_spatial_pool=1),
        rl=dataclasses.replace(ct.rl, context_policy=policy),
        run=dataclasses.replace(ct.run, run_dir=str(tmp_path), log_every=1),
        imitation=dataclasses.replace(ct.imitation, checkpoint_every=1))
    return c


@pytest.mark.parametrize("scheme, frame, policy", [("explicit", 48, "canvas"),
                                                   ("raster", 160, "attention")])
def test_run_on_the_device_source(tmp_path, scheme, frame, policy):
    _, ct = _configs(policy)
    cfg = _run_cfg(ct, tmp_path, scheme, frame, policy)
    rows = []
    state = tim.run(cfg, steps=2, log_cb=lambda i, m: rows.append(m), data_texture=1.0,
                    data_texture_vel=0.0, device="cpu")
    assert state.step == 2 and len(rows) == 2
    assert all(np.isfinite(float(v)) for m in rows for v in m.values())
    assert "Imitation/exposure" in rows[0]
    (path,) = glob.glob(str(tmp_path / "warm_start_pn2" / "*"))
    with open(os.path.join(path, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"Loss/expert_loss", "Imitation/top2_acc", "Imitation/exposure"} <= tags
    assert sorted(os.listdir(os.path.join(path, "checkpoints"))) == ["0", "1"]
    if scheme == "raster":
        with pytest.raises(ValueError, match="pn2_num_frames"):
            tim.run(cfg.replace(model=dataclasses.replace(cfg.model, pn2_num_frames=8)),
                    steps=1, device="cpu")
