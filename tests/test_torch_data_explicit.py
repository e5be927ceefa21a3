"""The port's explicit-teacher data and its on-device synthetic source
(rovr_torch/data/{teacher,corruption,synthetic,dataset,device_synthetic}.py)
against the JAX package.

Bit for bit under the same `np.random.Generator`: the teacher assignment,
the explicit corruption, `synthetic_explicit_batch`, `SyntheticExplicitDataset`,
the raster box masks (`raster_box_masks` against `raster_box_masks_jax`)
and the raster pair tables. The device source's pure functions take the
JAX functions' `jax.random` draws, replayed, and must give their clips and
masks within 1e-6 (f32 sin, cos and exp of two libraries). The sources
themselves are held to their contract: shapes, the [0, 1] range, masked
pixels zero, raster masks equal to `raster_box_masks`, overlap-free teacher
pairs exposing every hole, determinism per (seed, i).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.config import Config as JConfig
from rovr_tpu.data import corruption as jcorruption
from rovr_tpu.data import dataset as jdataset
from rovr_tpu.data import device_synthetic as jdev
from rovr_tpu.data import synthetic as jsynthetic
from rovr_tpu.data import teacher as jteacher
from rovr_torch.config import Config, from_dict
from rovr_torch.data import corruption, dataset, device_synthetic, synthetic, teacher
from rovr_torch.train import rl


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_teacher_assignment_matches_jax(seed):
    a = teacher.sample_assignment(np.random.default_rng(seed))
    b = jteacher.sample_assignment(np.random.default_rng(seed))
    for f in ("locations", "frame_order", "frame_masks", "positives", "negatives"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.groups == b.groups
    assert a.positives.shape == (teacher.NUM_FRAMES, 16, 2)
    assert a.negatives.shape == (teacher.NUM_FRAMES, 3, 2)


@pytest.mark.parametrize("h, w", [(256, 256), (64, 96), (37, 51)])
def test_explicit_corruption_matches_jax(h, w):
    frame = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for loc in (0, 5, 13, 19):
        m_t = corruption.corrupt_mask_explicit(h, w, loc, np.random.default_rng(loc),
                                               np.ones_like(frame))
        m_j = jcorruption.corrupt_mask_explicit(h, w, loc, np.random.default_rng(loc),
                                                np.ones_like(frame))
        np.testing.assert_array_equal(m_t, m_j)
    got = corruption.corrupt_frame_explicit(frame, [1, 8, 17, 3], np.random.default_rng(9))
    want = jcorruption.corrupt_frame_explicit(frame, [1, 8, 17, 3], np.random.default_rng(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].min() == 0  # boxes were cut
    for name in ("EXPLICIT_BOX_H", "EXPLICIT_BOX_W", "EXPLICIT_JITTER_X_LO",
                 "EXPLICIT_JITTER_X_HI", "EXPLICIT_JITTER_Y_LO", "EXPLICIT_JITTER_Y_HI"):
        assert getattr(corruption, name) == getattr(jcorruption, name), name


@pytest.mark.parametrize("seed, h, w", [(0, 64, 64), (5, 48, 80)])
def test_synthetic_explicit_batch_and_dataset_match_jax(seed, h, w):
    got = synthetic.synthetic_explicit_batch(seed, h, w)
    want = jsynthetic.synthetic_explicit_batch(seed, h, w)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cfg_j = JConfig()
    cfg_j = cfg_j.replace(data=dataclasses.replace(cfg_j.data, frame_size=(h, w)))
    ds_t = dataset.SyntheticExplicitDataset(from_dict(dataclasses.asdict(cfg_j)).data, seed=seed)
    ds_j = jdataset.SyntheticExplicitDataset(cfg_j.data, seed=seed)
    assert len(ds_t) == len(ds_j) == 64
    for a, b in zip(ds_t[3], ds_j[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h, w", [(256, 256), (160, 160), (64, 64), (37, 51)])
def test_raster_box_masks_match_jax(h, w):
    idx = 2 * np.arange(40)
    got = corruption.raster_box_masks(torch.from_numpy(idx), h, w).numpy()
    want = np.asarray(jcorruption.raster_box_masks_jax(idx, h, w))
    assert got.dtype == np.float32 and got.shape == (40, h, w, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s, h, w, seed", [(20, 160, 160, 0), (20, 256, 256, 3), (24, 200, 180, 1)])
def test_raster_pair_tables_match_jax(s, h, w, seed):
    for fn, per in (("raster_positive_pairs", 16), ("raster_negative_pairs", 3)):
        got = getattr(device_synthetic, fn)(s, h, w, per, seed)
        want = getattr(jdev, fn)(s, h, w, per, seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=fn)
    with pytest.raises(ValueError, match="too small"):
        device_synthetic.raster_positive_pairs(20, 64, 64)


def _jax_clip_draws(key, b, h, w, s, texture, vel):
    """synthetic_clips' draws, split as the JAX function splits its key."""
    ks = jax.random.split(key, 7)
    u = jax.random.uniform
    d = dict(phase=u(ks[0], (b, 3), minval=0.0, maxval=2 * np.pi),
             speed=u(ks[1], (b, 3), minval=0.5, maxval=2.0),
             blob_xy=u(ks[2], (b, 4, 2), minval=0.2, maxval=0.8),
             blob_v=u(ks[3], (b, 4, 2), minval=-0.02, maxval=0.02),
             blob_col=u(ks[4], (b, 4, 3), minval=0.3, maxval=1.0))
    if texture > 0:
        gh, gw = device_synthetic.texture_grid_shape(h, w, s, vel)
        d["grid"] = u(ks[5], (b, gh, gw, 3))
        d["vel"] = u(ks[6], (b, 2), minval=-vel, maxval=vel)
    return device_synthetic.ClipDraws(**{k: _t(v) for k, v in d.items()})


def _jax_jitter(key, shape):
    kx, ky = jax.random.split(key)
    return (_t(jax.random.randint(kx, shape, jcorruption.EXPLICIT_JITTER_X_LO,
                                  jcorruption.EXPLICIT_JITTER_X_HI + 1)),
            _t(jax.random.randint(ky, shape, jcorruption.EXPLICIT_JITTER_Y_LO,
                                  jcorruption.EXPLICIT_JITTER_Y_HI + 1)))


@pytest.mark.parametrize("b, h, w, s, texture, vel", [
    (2, 48, 40, 5, 0.0, 1.5),   # no texture
    (2, 48, 40, 7, 1.0, 1.5),   # drifting texture
    (3, 33, 64, 20, 0.5, 0.0),  # static texture, half blended
    (2, 40, 40, 6, 1.0, 2.3),   # drift past a cell per frame
])
def test_synthetic_clips_on_replayed_draws(b, h, w, s, texture, vel):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdev.synthetic_clips(key, b, h, w, s, texture, vel))
    got = device_synthetic.synthetic_clips_from_draws(
        _jax_clip_draws(key, b, h, w, s, texture, vel), h, w, s, texture, vel).numpy()
    assert got.shape == want.shape == (b, s, h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("overlap_free", [False, True])
def test_explicit_batch_on_replayed_draws(overlap_free):
    """explicit_batch_device = clips(k_clip) * masks(k_mask), both replayed."""
    b, s, h, w = 2, 20, 64, 96
    rng = np.random.default_rng(0)
    fm = np.stack([jteacher.sample_assignment(rng).frame_masks for _ in range(b)]).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in jdev.explicit_batch_device(
        key, jnp.asarray(fm), h, w, 1.0, 1.5, overlap_free)]
    k_clip, k_mask = jax.random.split(key)
    clips = device_synthetic.synthetic_clips_from_draws(
        _jax_clip_draws(k_clip, b, h, w, s, 1.0, 1.5), h, w, s, 1.0, 1.5)
    masks = device_synthetic._explicit_masks(
        torch.from_numpy(fm), h, w, None if overlap_free else _jax_jitter(k_mask, fm.shape),
        overlap_free)
    np.testing.assert_array_equal(masks.numpy(),
                                  np.asarray(jdev._explicit_masks(k_mask, jnp.asarray(fm), h, w,
                                                                  overlap_free)))
    for got, ref in zip((clips * masks, clips, masks.expand(clips.shape)), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_raster_batch_on_replayed_draws():
    b, h, w = 2, 160, 160
    key = jax.random.PRNGKey(11)
    want = [np.asarray(x) for x in jdev.raster_batch_device(key, b, h, w, 20, 1.0, 0.0)]
    clips = device_synthetic.synthetic_clips_from_draws(
        _jax_clip_draws(key, b, h, w, 20, 1.0, 0.0), h, w, 20, 1.0, 0.0)
    masks = corruption.raster_box_masks(2 * torch.arange(20), h, w)
    for got, ref in zip((clips * masks, clips, masks.expand(clips.shape)), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def _cfg(scheme, frame=64, overlap_free=False):
    c = Config()
    return c.replace(data=dataclasses.replace(c.data, frame_size=(frame, frame),
                                              synthetic_scheme=scheme,
                                              synthetic_overlap_free=overlap_free))


@pytest.mark.parametrize("scheme, texture", [("explicit", 0.0), ("explicit", 1.0),
                                             ("raster", 0.0), ("raster", 1.0)])
def test_make_source_contract(scheme, texture):
    frame = 160 if scheme == "raster" else 64
    src = device_synthetic.make_source(_cfg(scheme, frame), 2, 5, texture, 1.5, device="cpu")
    corrupted, original, masks, pos, neg = src.next(0)
    shape = (2, teacher.NUM_FRAMES, frame, frame, 3)
    for x in (corrupted, original, masks):
        assert x.shape == shape and x.dtype == torch.float32 and x.device.type == "cpu"
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert set(torch.unique(masks).tolist()) == {0.0, 1.0}
    assert torch.equal(corrupted, original * masks)
    assert float(corrupted[masks == 0].abs().max()) == 0.0
    again = src.next(0)
    assert torch.equal(again[0], corrupted) and torch.equal(again[1], original)
    assert not torch.equal(src.next(1)[1], original)
    if scheme == "raster":
        assert pos is None and neg is None
        want = corruption.raster_box_masks(2 * torch.arange(teacher.NUM_FRAMES), frame, frame)
        assert torch.equal(masks, want[None].expand(shape))
    else:
        assert pos.shape == (2, 20, 16, 2) and neg.shape == (2, 20, 3, 2)
        rng = np.random.default_rng((5, 0))  # the host teacher draws of batch 0
        np.testing.assert_array_equal(pos[0], teacher.sample_assignment(rng).positives)
    if texture:  # texture adds mid-frequency detail the smooth clips lack
        plain = device_synthetic.make_source(_cfg(scheme, frame), 2, 5, 0.0, 1.5, "cpu")
        rough = lambda v: float((v[:, :, 1:] - v[:, :, :-1]).abs().mean())  # noqa: E731
        assert rough(original) > 2 * rough(plain.next(0)[1])


def test_overlap_free_teacher_pairs_expose_every_hole():
    """Cell-aligned boxes make the teacher's group-exposure property exact:
    the first 8 positive pairs of each frame expose all its hole pixels."""
    src = device_synthetic.make_source(_cfg("explicit", 96, overlap_free=True), 1, 2, 0.0,
                                       1.5, "cpu")
    _, _, masks, pos, _ = src.next(0)
    hole = 1.0 - masks[0, ..., 0]
    for t in range(teacher.NUM_FRAMES):
        for a, b in pos[0, t, :8]:
            assert float((hole[t] * hole[a] * hole[b]).sum()) == 0.0, (t, a, b)


def test_drivers_default_source_cuts_frames_and_refuses_long_clips():
    c = _cfg("raster", 160)
    cfg = c.replace(rl=dataclasses.replace(c.rl, vid_length=7))
    v, o, m = rl.DeviceSyntheticSource(cfg, 2, 1.0, 0.0, "cpu").next(3)
    assert v.shape == o.shape == m.shape == (2, 7, 160, 160, 3)
    long_cfg = c.replace(rl=dataclasses.replace(c.rl, vid_length=21))
    with pytest.raises(ValueError, match="20-frame"):
        rl.DeviceSyntheticSource(long_cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="20-frame"):
        rl.run(long_cfg, iterations=1, device="cpu")
    with pytest.raises(NotImplementedError, match="no textured clips"):
        rl.HostSyntheticSource(cfg, 2, data_texture=1.0)
