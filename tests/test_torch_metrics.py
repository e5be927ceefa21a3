"""The port's metrics (rovr_torch/ops/metrics.py) against rovr_tpu.ops.metrics
on seeded numpy inputs, float32, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.ops import metrics as jm
from rovr_torch.ops import metrics as tm


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(*shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return x, y


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(3, 24, 20, 3), (2, 3, 16, 16, 3), (16, 12, 1)])
def test_psnr_and_ssim_any_leading_axes(shape):
    x, y = _pair(*shape, seed=len(shape))
    for f in ("psnr", "ssim"):
        got = getattr(tm, f)(torch.from_numpy(x), torch.from_numpy(y))
        want = getattr(jm, f)(jnp.asarray(x), jnp.asarray(y))
        assert tuple(got.shape) == tuple(want.shape) == shape[:-3]
        _close(got, want)
    same = tm.psnr(torch.from_numpy(x), torch.from_numpy(x))  # mse 0 -> the 1e-12 floor
    _close(same, jm.psnr(jnp.asarray(x), jnp.asarray(x)))


def test_preservation_flow_recovery_spatio_and_magnitudes():
    rng = np.random.default_rng(1)
    org = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    org[2] = 0.0  # guarded by eps
    comp, bad, recon = (rng.uniform(0.5, 2.0, 7).astype(np.float32) for _ in range(3))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    j = jnp.asarray
    _close(tm.preservation(t(org), t(comp)), jm.preservation(j(org), j(comp)))
    _close(tm.flow_recovery(t(recon), t(org), t(bad)), jm.flow_recovery(j(recon), j(org), j(bad)))
    _close(tm.spatio_reward(t(recon), t(org), t(bad), 3.0),
           jm.spatio_reward(j(recon), j(org), j(bad), 3.0))
    flows = rng.standard_normal((2, 5, 8, 6, 2)).astype(np.float32)
    _close(tm.flow_magnitudes(t(flows)), jm.flow_magnitudes(j(flows)))
    assert float(tm.flow_recovery(t(org[:1]), t(org[:1]), t(bad[:1]))) == 1.0


def _exposure_inputs(seed):
    """Holes of 3 clips x 6 frames, one clip with no hole at all; pairs with
    both contexts the same frame and contexts equal to the target (ties)."""
    rng = np.random.default_rng(seed)
    b, s, t = 3, 6, 5
    hole = (rng.uniform(size=(b, s, 10, 9, 1)) < 0.4).astype(np.float32)
    hole[1] = 0.0
    tgt = np.stack([np.arange(t) % s] * b, axis=1).astype(np.int32)   # (T, B)
    pairs = rng.integers(0, s, size=(t, b, 2)).astype(np.int32)
    pairs[0, :, 1] = pairs[0, :, 0]
    pairs[1, :, 0] = tgt[1]
    return hole, tgt, pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_context_exposure_pooled_and_per_clip(seed):
    hole, tgt, pairs = _exposure_inputs(seed)
    args_t = [torch.from_numpy(a) for a in (hole, tgt, pairs)]
    args_j = [jnp.asarray(a) for a in (hole, tgt, pairs)]
    _close(tm.context_exposure(*args_t), jm.context_exposure(*args_j))
    per = tm.context_exposure_per_clip(*args_t)
    _close(per, jm.context_exposure_per_clip(*args_j))
    assert float(per[1]) == 0.0  # no hole pixels: 0 / max(0, 1)
    empty = [torch.zeros_like(args_t[0])] + args_t[1:]
    assert float(tm.context_exposure(*empty)) == 0.0
