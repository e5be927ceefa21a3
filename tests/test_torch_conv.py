"""K1 (rovr_torch/ops/conv.py) against the Pallas kernel it replaces.

On the CPU the wrapper runs the plain version (nine shifted f32 matmuls);
it is held against `rovr_tpu.ops.pallas.conv.fused_conv3x3` in Pallas
interpret mode and against the XLA `_reference`, at test_pallas_conv.py's
shapes, at f32 (atol/rtol 1e-4: f32 sums in another order). The CUDA kernel
itself is compared with the plain version on the card by the `cuda`-marked
test in tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.ops.pallas import conv as pconv
from rovr_torch.models import layers as tl
from rovr_torch.ops import conv as tconv

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, h, w, cin, cout, bias_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * bias_scale).astype(np.float32)
    return x, k, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("h,w,cin,cout", [
    (16, 16, 8, 16), (32, 16, 8, 8),
    # the plain version against Pallas at the kernel's ragged shapes: Cin = 72
    # (a 64-channel slice and 8 more), W = 29, and both with an odd H
    (8, 16, 72, 16), (12, 29, 8, 24), (9, 29, 72, 40),
])
def test_plain_matches_pallas_interpret_and_reference(h, w, cin, cout):
    x, k, b = _inputs(0, 2, h, w, cin, cout)
    ours = tconv.fused_conv3x3(*_t(x, k, b), True).numpy()
    interp = np.asarray(pconv.fused_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(b), True, True))
    ref = np.asarray(pconv._reference(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(b), True))
    np.testing.assert_allclose(ours, interp, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_no_relu():
    x, k, b = _inputs(1, 1, 16, 16, 4, 4)
    b = np.ones_like(b)
    ours = tconv.fused_conv3x3(*_t(x, k, b), False).numpy()
    ref = np.asarray(pconv._reference(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(b), False))
    assert ref.min() < 0  # relu genuinely off
    np.testing.assert_allclose(ours, ref, **TOL)


def test_gradients_match_pallas_vjp():
    import jax

    x, k, b = _inputs(2, 1, 16, 8, 4, 4)
    xt, kt, bt = (t.requires_grad_() for t in _t(x, k, b))
    (tconv.fused_conv3x3(xt, kt, bt, True) ** 2).sum().backward()

    def loss(x, k, b):
        return jnp.sum(pconv.fused_conv3x3(x, k, b, True, True) ** 2)

    gj = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(b))
    for ours, theirs in zip((xt.grad, kt.grad, bt.grad), gj):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_cpu_runs_plain_and_counts_no_launch():
    x, k, b = _inputs(3, 1, 8, 8, 8, 8)
    before = tconv.fused_conv3x3.launches
    y = tconv.fused_conv3x3(*_t(x, k, b))
    np.testing.assert_array_equal(
        y.numpy(), tconv.fused_conv3x3_plain(*_t(x, k, b)).numpy())
    assert tconv.fused_conv3x3.launches == before


def test_plain_rounds_kernel_to_input_dtype():
    """As the TPU op casts W to x's dtype, bf16 x means bf16-rounded W."""
    x, k, b = _inputs(4, 1, 8, 8, 8, 8)
    xb = torch.from_numpy(x).bfloat16()
    y = tconv.fused_conv3x3_plain(xb, torch.from_numpy(k), torch.from_numpy(b))
    y_rounded = tconv.fused_conv3x3_plain(
        xb, torch.from_numpy(k).bfloat16(), torch.from_numpy(b))
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, y_rounded, atol=0, rtol=0)


@pytest.mark.parametrize("bad,err", [
    (dict(x_dtype=torch.float32), TypeError),
    (dict(cin=12), ValueError),
    (dict(cout=20), ValueError),
    (dict(bias_dtype=torch.bfloat16), TypeError),
    (dict(noncontig=True), ValueError),
    (dict(kernel_shape=(3, 3, 8, 16, 1)), ValueError),
])
def test_kernel_arg_checks_refuse(bad, err):
    cin, cout = bad.get("cin", 8), bad.get("cout", 16)
    x = torch.zeros(1, 4, 4, cin, dtype=bad.get("x_dtype", torch.bfloat16))
    if bad.get("noncontig"):
        x = torch.zeros(1, 4, cin, 4, dtype=torch.bfloat16).transpose(2, 3)
    k = torch.zeros(bad.get("kernel_shape", (3, 3, cin, cout)), dtype=torch.bfloat16)
    b = torch.zeros(cout, dtype=bad.get("bias_dtype", torch.float32))
    with pytest.raises(err):
        tconv.check_kernel_args(x, k, b)


def test_kernel_arg_checks_accept_serving_shape():
    x = torch.zeros(2, 8, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 128, 256, dtype=torch.bfloat16)
    tconv.check_kernel_args(x, k, torch.zeros(256))


def test_module_impls():
    x, k, b = _inputs(5, 2, 8, 8, 8, 16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mods = {impl: tl.FusedConv3x3(8, 16, impl=impl) for impl in ("auto", "plain", "kernel")}
    for m in mods.values():
        m.load_state_dict({"weight": torch.from_numpy(k).permute(3, 2, 0, 1),
                           "bias": torch.from_numpy(b)})
    with torch.no_grad():
        np.testing.assert_array_equal(mods["auto"](xt).numpy(), mods["plain"](xt).numpy())
        with pytest.raises(ValueError, match="CUDA"):
            mods["kernel"](xt)
    with pytest.raises(ValueError):
        tl.FusedConv3x3(8, 16, impl="pallas")
