"""Ring attention in the port (rovr_torch/parallel/ring_attention.py,
`attn_impl="ring"`) on the CPU over gloo processes, against the JAX
package's `ring_self_attention_sharded` on a CPU mesh of the same shape and
against the single-process port.

  * the ring over a model axis of 2 against JAX's over 2 devices: the same
    (2, 2, 64, 32) f32 inputs from a numpy seed, atol 1e-5
    (tests/test_attention.py's own bound), and the gradients of sum(out * w)
    against jax.grad (1e-5);
  * `_attend(impl="ring")` with the heads split over the axis (tensor
    parallel + ring) against plain attention on this rank's heads (1e-5);
  * a length that does not split over the axis raises;
  * the config's ring train step at (data, model) = (1, 2) and (2, 2)
    against the single-process `train_step` on the global batch (the
    default flash path: the same function at f32), with
    tests/test_torch_data_parallel.py's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rovr_tpu.parallel.ring_attention import ring_self_attention_sharded

import torch_model_workers as workers
from test_torch_data_parallel import _case, _cfg


def _qkvw(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 2, 64, 32)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    torch.set_num_threads(2)
    q, k, v, w = _qkvw()
    cfg = _cfg("attention", attn_impl="ring")
    step = dict(kind="train", **_case(cfg, 4))
    ranks = {grid: workers.spawn_cases(
        dict(fn=dict(kind="ring_fn", q=q, k=k, v=v, w=w), step=step),
        tmp_path_factory.mktemp(f"ring{grid[0]}{grid[1]}"), *grid)
        for grid in ((1, 2), (2, 2))}
    ref_cfg = cfg.replace(model=dataclasses.replace(cfg.model, attn_impl="auto"))
    return dict(ranks=ranks, inputs=(q, k, v, w), cfg=cfg, ref=workers.single_step(ref_cfg, step))


def test_ring_matches_jax_ring_and_its_gradients(ring):
    q, k, v, w = (jnp.asarray(a) for a in ring["inputs"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    want = np.asarray(ring_self_attention_sharded(mesh, q, k, v, "seq"))
    grads = jax.grad(lambda q, k, v: jnp.sum(
        ring_self_attention_sharded(mesh, q, k, v, "seq") * w), argnums=(0, 1, 2))(q, k, v)
    for got in ring["ranks"][(1, 2)]:
        np.testing.assert_allclose(got["fn"]["out"].numpy(), want, atol=1e-5)
        for g, gw in zip(got["fn"]["grads"], grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(gw), atol=1e-5)


def test_ring_with_a_data_axis_gives_the_whole_output(ring):
    """At (2, 2) the batch splits over the data axis and the sequence over
    the model axis; every rank gets the whole output and gradient."""
    one = ring["ranks"][(1, 2)][0]["fn"]
    for got in ring["ranks"][(2, 2)]:
        np.testing.assert_allclose(got["fn"]["out"].numpy(), one["out"].numpy(), atol=1e-6)
        for g, g1 in zip(got["fn"]["grads"], one["grads"]):
            np.testing.assert_allclose(g.numpy(), g1.numpy(), atol=1e-6)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_ring_with_split_heads_and_the_refusal(ring, grid):
    for got in ring["ranks"][grid]:
        fn = got["fn"]
        assert fn["heads"].shape == fn["heads_want"].shape == (2 // grid[0], 1, 64, 32)
        np.testing.assert_allclose(fn["heads"].numpy(), fn["heads_want"].numpy(), atol=1e-5)
        assert fn["odd"] is not None and "must divide" in fn["odd"], fn["odd"]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_ring_train_step_equals_the_global_batch_step(ring, grid):
    for got in ring["ranks"][grid]:
        workers.assert_step_matches(got["step"], ring["ref"], ring["cfg"])
        # the ring's k/v passes: sends over the model axis, no K2 anywhere
        assert got["step"]["calls"].get("model:send_recv", 0) > 0
