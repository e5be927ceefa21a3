"""Faults planted under the timed path, for the tests and the calibration
that show the check reads them: each a context manager that breaks the
program in one way while the block runs.

Train cells: `frozen` (the step hands back the state it was given),
`half_batch` (PPO takes the first half of the clips and means over them),
`half_loss` (the actor's loss is meaned over the first half of the rows,
every shape kept), `altered` (one UNet frame of each step is shifted where
it is produced), `stale` (from the fourth step on, past the set-up's three,
the rollout acts on the actor's weights of the first step, as a cache of
cast weights that is never refreshed would).
Serve cells: `half_batch` (the second half of each batch is handed back
as it came in), `altered` (one returned frame has a band of bytes changed).
"""

from __future__ import annotations

import contextlib

import numpy as np

import program
from rovr_torch.train import rl

TRAIN = ("frozen", "half_batch", "half_loss", "altered", "stale")
SERVE = ("half_batch", "altered")


def _half_traj(traj, gumbel):
    h = traj.actions.shape[1] // 2
    t = traj.actions.shape[0]
    cut = traj._replace(obs=tuple(x[:, :h] for x in traj.obs), target_idx=traj.target_idx[:, :h],
                        actions=traj.actions[:, :h], logprobs=traj.logprobs[:, :h],
                        rtgs=traj.rtgs[:, :h])
    return cut, None if gumbel is None else gumbel[:, :h * t]


@contextlib.contextmanager
def planted(name: str, kind: str, mods):
    """Break the program with fault `name` of a `kind` ("train"/"serve") cell."""
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if kind == "train" and name == "frozen":
        step = program.train_step
        patch(program, "train_step",
              lambda st, *a, **k: (st,) + tuple(step(st, *a, **k)[1:]))
    elif kind == "train" and name == "half_batch":
        ppo = rl.ppo_update

        def half(state, mods_, cfg, traj, generator=None, gumbel=None, mesh=None):
            traj, gumbel = _half_traj(traj, gumbel)
            return ppo(state, mods_, cfg, traj, generator, gumbel, mesh)

        patch(rl, "ppo_update", half)
    elif kind == "train" and name == "half_loss":
        loss = rl.actor_loss

        def half_rows(mods_, cfg, obs, tgt, acs, old_logp, adv, gumbel=None, generator=None):
            h = tgt.shape[0] // 2
            return loss(mods_, cfg, tuple(x[:h] for x in obs), tgt[:h], acs[:h], old_logp[:h],
                        adv[:h], None if gumbel is None else gumbel[:h], generator)

        patch(rl, "actor_loss", half_rows)
    elif kind == "train" and name == "stale":
        roll = rl.rollout
        first, calls = [], [0]

        def stale(state, *a, **k):
            calls[0] += 1
            if not first:
                first.append(state.actor2_params)
            elif calls[0] > 3:
                state = state._replace(actor2_params=first[0])
            return roll(state, *a, **k)

        patch(rl, "rollout", stale)
    elif kind == "train" and name == "altered":
        unet = mods.local_net
        calls = {"n": 0}
        forward = unet.forward

        def shifted(*a, **k):
            y = forward(*a, **k)
            calls["n"] += 1
            if calls["n"] % 7 == 3:
                y = y.clone()
                y[0] = (y[0] + 0.25).clamp(0.0, 1.0)
            return y

        patch(unet, "forward", shifted)
    elif kind == "serve" and name in SERVE:
        serve = program.serve

        def broken(cfg, st, mods_, batches):
            held = []

            def feed():
                for v in batches:
                    held.append(np.asarray(v))
                    yield v if name == "altered" else held[-1][:len(held[-1]) // 2]

            for i, (frames, pairs) in enumerate(serve(cfg, st, mods_, feed())):
                v = held[i]
                if name == "half_batch":
                    frames = np.concatenate([frames, v[len(frames):]])
                    pairs = np.concatenate([pairs, pairs], axis=1)
                else:
                    frames = frames.copy()
                    frames[0, 0, :16] ^= 0x40
                yield frames, pairs

        patch(program, "serve", broken)
    else:
        raise ValueError(f"no fault {name!r} for a {kind} cell")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if attr == "forward":
                del obj.forward
            else:
                setattr(obj, attr, old)
