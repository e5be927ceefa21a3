"""The reference of a configuration that logs RAFT's flow term spatio
(`rl.log_spatio`, as the original code computes and logs it): the episode
reference (`episode.Ref`), then, at the episode's end, φ, each clip's
total flow magnitude by the plain RAFT-small of `raft.py`, of the
reconstruction, the original and the corrupted clip, and spatio =
(1 - |φ(recon) - φ(org)| / |φ(corrupted) - φ(org)|) · spatio_scale
(rovr/rovr.py:223-241).

What check.py reads here: `EXTRA_METRICS`, the program's `Episode/spatio`
and the means over the clips of its three φ, kept in its records;
`extra_numbers` (below); `extra_flops`, RAFT's work in a train step.
`raft_bound_ms` is RAFT's least time a step, which the cell's file keeps
for the metric `raft_roofline.train`.

RAFT is judged by its φ (`phi_gap`), not by spatio: spatio is a ratio of
differences of flow magnitudes, and under drawn weights RAFT's flow
hardly depends on the frames, so |φ(corrupted) - φ(org)| can be a
thousandth of φ and a relative error of φ far below bfloat16's moves
spatio by any amount. Its gap over spatio_scale (`spatio_gap`) is read
beside it, and held by no limit. For the same reason a configuration that
adds spatio to the reward (`rl.use_spatio_reward`) is refused: its
rewards-to-go are not determined by the frames to the program's precision
(PERF.md, section 7).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import episode
from . import raft as R

adam_state = episode.adam_state
PASSES = ("recon", "org", "corrupted")   # the clips φ is taken of
EXTRA_METRICS = ("Episode/spatio",) + tuple(f"Episode/phi_{p}" for p in PASSES)
PEAK_BF16_FLOPS = 989e12    # H100 SXM, dense bf16 (work.py's)
PEAK_BYTES = 3.35e12        # H100 SXM, HBM3 (work.py's)


class Ref(episode.Ref):
    def __init__(self, cfg: dict, weights, precision: str = "f32"):
        rl = cfg["rl"]
        if rl["use_spatio_reward"]:
            raise ValueError("reference 'spatio' follows a logged spatio only (rl.log_spatio): "
                             "a rewarded one is not determined by the frames (PERF.md, "
                             "section 7)")
        super().__init__(cfg, weights, precision)
        self.scale, self.flow_size = rl["spatio_scale"], R.flow_size(cfg)

    @torch.no_grad()
    def rollout(self, video, org=None, gumbel=None, actions=None) -> dict:
        """`episode.Ref.rollout`; with rewards, spatio (B,) and the metrics
        `spatio` (its mean over the clips), `spatio_scale` and `phi_<clip>`,
        the mean of each clip's φ of the reconstruction, the original and
        the corrupted clip."""
        res = super().rollout(video, org, gumbel, actions)
        if org is None:
            return res
        phis = {name: R.phi(self.P, self.w["raft"], x.float(), self.flow_size)
                for name, x in zip(PASSES, (res["recon"], org, video))}
        o = phis["org"]
        spatio = (1.0 - (phis["recon"] - o).abs() / (phis["corrupted"] - o).abs()) * self.scale
        res["metrics"].update(spatio=spatio.mean(), spatio_scale=torch.tensor(float(self.scale)),
                              **{f"phi_{name}": phi.mean() for name, phi in phis.items()})
        return res


def _metric(rec: dict, name: str) -> float:
    """A record's metric: the program's under its full name, a reference
    record's (the control's, in calibrate.py) under its own."""
    m = rec["metrics"]
    return m[f"Episode/{name}"] if f"Episode/{name}" in m else m[name]


def extra_numbers(steps: List[tuple]) -> Dict[str, float]:
    """Over the followed steps: `phi_gap`, the largest relative gap of the
    program's mean φ of a clip (reconstruction, original, corrupted) to the
    reference's; `spatio_gap`, the largest |program's spatio - reference's|
    over spatio_scale, the reward at full recovery."""
    out = {"phi_gap": 0.0, "spatio_gap": 0.0}
    for p, r in steps:
        for name in PASSES:
            ref = r["metrics"][f"phi_{name}"]
            out["phi_gap"] = max(out["phi_gap"], abs(_metric(p, f"phi_{name}") - ref) / ref)
        gap = abs(_metric(p, "spatio") - r["metrics"]["spatio"]) / r["metrics"]["spatio_scale"]
        out["spatio_gap"] = max(out["spatio_gap"], gap)
    return out


def _pairs(cfg: dict) -> int:
    """Frame pairs through RAFT in one pass: B * (S - 1)."""
    rl = cfg["rl"]
    return rl["batch_size"] * (rl["vid_length"] - 1)


def _on(cfg: dict, kind: str) -> bool:
    return kind == "train" and (cfg["rl"]["use_spatio_reward"] or cfg["rl"]["log_spatio"])


def extra_flops(cfg: dict, kind: str) -> float:
    """RAFT's FLOPs in a unit: three passes of B * (S - 1) pairs at the
    flow size, in a train step; none in a served batch."""
    if not _on(cfg, kind):
        return 0.0
    return len(PASSES) * _pairs(cfg) * R.pair_flops(R.flow_size(cfg))


def raft_bound_ms(cfg: dict) -> float:
    """RAFT's least time a train step, whatever implements it: per pass the
    larger of its FLOPs at the bf16 peak and its bytes at HBM's rate, the
    bytes being the f32 pyramid written once and, each iteration, the f32
    lookup output (N, 196, h/8, w/8) written once; over the three passes."""
    n, size = _pairs(cfg), R.flow_size(cfg)
    h = w = size // 8
    pyramid = sum((h >> lvl) * (w >> lvl) for lvl in range(R.NUM_LEVELS)) * h * w
    taps = R.NUM_LEVELS * (2 * R.RADIUS + 1) ** 2
    nbytes = 4.0 * n * (pyramid + R.ITERS * taps * h * w)
    flops = n * R.pair_flops(size)
    return len(PASSES) * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
