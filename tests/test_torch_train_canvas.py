"""The port's RL train step with the canvas context policy (`Config()`'s)
against the JAX package on the CPU: first-epoch gradients and one full
train step, as tests/test_torch_train.py checks the attention policy
(same configuration, replayed noise and tolerances; the canvas case lives
in its own file so that each file stays under a minute)."""

from test_torch_train import check_first_epoch_gradients, check_train_step


def test_first_epoch_gradients_match_jax_grad_canvas():
    check_first_epoch_gradients("canvas")


def test_train_step_matches_jax_canvas():
    check_train_step("canvas")
