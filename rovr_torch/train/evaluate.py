"""Reconstruction evaluation: agentic against sequential sampling
(rovr_tpu/train/evaluate.py, PyTorch port).

The headline metric is flow recovery O = 1 - |φ(recon) - φ(org)| /
|φ(corrupted) - φ(org)| with φ the total RAFT flow magnitude of a clip,
for the policy's (agentic) reconstruction and the sequential (t-2, t-1)
baseline's; PSNR, SSIM, LPIPS, masked PSNR and context exposure ride along.
`eval_ci_step` and `run_ci` give per-clip weight-free metrics under the
greedy and the sampled readout, with t-interval confidence bounds.

The rollout is `rl.rollout` without its reward path (nothing here reads
the rewards; XLA drops them from the JAX graph the same way). RAFT is built
once and runs its frame pairs in chunks (`models/raft.pairwise_flows`).
Randomness is an input: the sampled readout's Gumbel noise is a tensor or
comes from a torch.Generator. Data: a dataset, a `source` with `next(i)`,
or, by default, the on-device synthetic source (`rl.DeviceSyntheticSource`,
textured clips included), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from rovr_torch.config import Config
from rovr_torch.device import resolve
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.raft import RAFTSmall, pairwise_flows, total_flow_magnitude
from rovr_torch.ops.metrics import (
    context_exposure,
    context_exposure_per_clip,
    flow_recovery,
    psnr,
    ssim,
)
from rovr_torch.train import rl


class EvalModules(NamedTuple):
    rovr: rl.ROVRModules
    raft: RAFTSmall


def make_modules(cfg: Config, dtype: Optional[torch.dtype] = None, raft_iters: int = 12,
                 device=None) -> EvalModules:
    """The RL module zoo and RAFT-small, on CUDA unless device="cpu"."""
    raft = RAFTSmall(iters=raft_iters, dtype=dtype or torch.bfloat16)
    return EvalModules(rovr=rl.make_modules(cfg, dtype=dtype, device=device),
                       raft=raft.to(resolve(device)).requires_grad_(False))


def init_raft_params(mods: EvalModules, seed: int) -> Dict[str, torch.Tensor]:
    """Fresh RAFT parameters drawn as flax draws them (no pretrained weights
    are available without a network)."""
    return flax_init_state(mods.raft, torch.Generator().manual_seed(seed))


def _to_device(x, dev) -> torch.Tensor:
    x = torch.as_tensor(x).to(dev)
    return x.float() * (1.0 / 255.0) if x.dtype == torch.uint8 else x


def _masked_psnr(x: torch.Tensor, org: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """Per-clip PSNR over the hole pixels only: (B,)."""
    se = ((x - org) ** 2 * hole).sum((1, 2, 3, 4))
    mse = se / hole.sum((1, 2, 3, 4)).clamp_min(1.0)
    return -10.0 * torch.log10(mse.clamp_min(1e-10))


def _seq_pairs(tgt_idx: torch.Tensor, s: int) -> torch.Tensor:
    return torch.stack([(tgt_idx - 2) % s, (tgt_idx - 1) % s], dim=-1)


@torch.no_grad()
def eval_step(state: rl.ROVRState, raft_params: Dict[str, torch.Tensor],
              mods: EvalModules, cfg: Config, batch, flow_size: int = 256,
              generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One eval pass over a clip batch (corrupted, original[, masks]), each
    (B, S, H, W, 3), uint8 or float in [0, 1]: flow recovery of agentic and
    sequential sampling, PSNR, SSIM and LPIPS; with masks also PSNR over the
    masked region and the context exposure of both. The sequential baseline
    is forced on, the readout is cfg.rl.eval_greedy (a sampled one draws
    `gumbel` (T, B, S) or from `generator`). Values are 0-dim tensors."""
    dev = next(mods.raft.parameters()).device
    video, org_video, *rest = (_to_device(x, dev) for x in batch)
    masks = rest[0] if rest else None
    cfg = cfg.replace(rl=dataclasses.replace(
        cfg.rl, sequential_baseline=True, greedy=cfg.rl.eval_greedy))
    out = rl.rollout(state, mods.rovr, cfg, video, org_video, generator,
                     rewards=False, gumbel=gumbel)
    mods.raft.load_state_dict({k: v.to(dev) for k, v in raft_params.items()},
                              strict=True, assign=True)
    mods.raft.requires_grad_(False)

    def phi(v):
        return total_flow_magnitude(pairwise_flows(mods.raft, v, flow_size))[0]

    f_org, f_bad = phi(org_video), phi(video)
    f_agentic, f_seq = phi(out.reconstructed), phi(out.experimental)
    lp = rl.per_frame_lpips(mods.rovr, state.lpips_params, out.reconstructed, org_video)
    extra = {}
    if masks is not None:
        hole = 1.0 - masks  # 1 where the corruption removed content
        hole1 = hole[..., :1]
        tgt_idx = out.traj.target_idx
        extra = {
            "Eval/masked_psnr_agentic": _masked_psnr(out.reconstructed, org_video, hole).mean(),
            "Eval/masked_psnr_sequential": _masked_psnr(out.experimental, org_video,
                                                        hole).mean(),
            "Eval/masked_psnr_corrupted": _masked_psnr(video, org_video, hole).mean(),
            "Eval/exposure_agentic": context_exposure(hole1, tgt_idx, out.traj.actions),
            "Eval/exposure_sequential": context_exposure(
                hole1, tgt_idx, _seq_pairs(tgt_idx, video.shape[1])),
        }
    return {
        **extra,
        "Eval/flow_recovery_agentic": flow_recovery(f_agentic, f_org, f_bad).mean(),
        "Eval/flow_recovery_sequential": flow_recovery(f_seq, f_org, f_bad).mean(),
        "Eval/psnr_agentic": psnr(out.reconstructed, org_video).mean(),
        "Eval/psnr_sequential": psnr(out.experimental, org_video).mean(),
        "Eval/psnr_corrupted": psnr(video, org_video).mean(),
        "Eval/ssim_agentic": ssim(out.reconstructed, org_video).mean(),
        "Eval/ssim_sequential": ssim(out.experimental, org_video).mean(),
        "Eval/lpips_agentic": lp.mean(),
    }


@torch.no_grad()
def eval_ci_step(state: rl.ROVRState, mods_rovr: rl.ROVRModules, cfg: Config, batch,
                 draws: int, generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-clip weight-free metrics under both readouts:
    {"greedy": {...}, "sampled": {...}}, each value (B,).

    batch = (corrupted, original, masks), each (B, S, H, W, 3). "greedy" is
    one deterministic top-2 rollout with the sequential baseline beside it;
    "sampled" is `draws` Gumbel-sampled rollouts per clip, averaged, run as
    `draws` replicas of the batch in one rollout that share the episode init
    computed once (the noise: `gumbel` (T, draws*B, S), replica-major, or
    from `generator`)."""
    dev = next(mods_rovr.local_net.parameters()).device
    video, org_video, masks = (_to_device(x, dev) for x in batch)
    b, s = video.shape[:2]
    cfg_g = cfg.replace(rl=dataclasses.replace(cfg.rl, greedy=True, sequential_baseline=True))
    cfg_s = cfg.replace(rl=dataclasses.replace(cfg.rl, greedy=False,
                                               sequential_baseline=False))
    hole = 1.0 - masks
    hole1 = hole[..., :1]

    def per_clip(out, org, h, h1):
        tgt = out.traj.target_idx
        return {
            "masked_psnr_agentic": _masked_psnr(out.reconstructed, org, h),
            "psnr_agentic": psnr(out.reconstructed, org).mean(-1),
            "exposure_agentic": context_exposure_per_clip(h1, tgt, out.traj.actions),
            "exposure_sequential": context_exposure_per_clip(h1, tgt, _seq_pairs(tgt, s)),
        }

    init = rl.episode_init(state, mods_rovr, cfg, video, org_video, rewards=False)
    out_g = rl.rollout(state, mods_rovr, cfg_g, video, org_video, rewards=False, init=init)
    g = per_clip(out_g, org_video, hole, hole1)
    g["masked_psnr_sequential"] = _masked_psnr(out_g.experimental, org_video, hole)
    g["psnr_sequential"] = psnr(out_g.experimental, org_video).mean(-1)
    g["masked_psnr_corrupted"] = _masked_psnr(video, org_video, hole)
    g["psnr_corrupted"] = psnr(video, org_video).mean(-1)

    def tile(x):
        return torch.cat([x] * draws, dim=0)

    # without rewards the init is the canvas and the features only
    init_t = init._replace(canvas=tile(init.canvas), feats=tile(init.feats))
    out_s = rl.rollout(state, mods_rovr, cfg_s, tile(video), tile(org_video), generator,
                       rewards=False, gumbel=gumbel, init=init_t)
    s_flat = per_clip(out_s, tile(org_video), tile(hole), tile(hole1))
    # (draws*B,) -> (draws, B) -> the mean over draws: the per-clip expected
    # metric under the sampled policy
    sampled = {k: v.reshape(draws, b).mean(0) for k, v in s_flat.items()}
    return {"greedy": g, "sampled": sampled}


def _tcrit(df: int) -> float:
    """Two-sided 95% t critical value (scipy)."""
    from scipy import stats

    return float(stats.t.ppf(0.975, max(df, 1)))


def summarize(vals) -> Dict[str, float]:
    """mean and 95% CI half-width (t-interval over clips) of a per-clip
    metric."""
    v = np.asarray(vals, np.float64)
    n = v.size
    se = v.std(ddof=1) / np.sqrt(n) if n > 1 else float("inf")
    return {"mean": float(v.mean()), "ci95": float(_tcrit(n - 1) * se), "n": int(n)}


def paired_delta(a, b) -> Dict[str, float]:
    """Paired per-clip difference a - b with its 95% t-interval, and
    whether it separates: |mean| > ci95."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    out = summarize(d)
    out["separates"] = bool(abs(out["mean"]) > out["ci95"])
    return out


def run_ci(cfg: Optional[Config] = None, state: Optional[rl.ROVRState] = None,
           num_videos: int = 100, sample_draws: int = 8, data_texture: float = 0.0,
           mods: Optional[EvalModules] = None,
           source=None, device=None, data_texture_vel: float = 1.5) -> Dict[str, Any]:
    """Held-out evaluation with confidence intervals: per-clip metrics over
    at least `num_videos` clips (batches of cfg.rl.batch_size), greedy and
    `sample_draws`-draw sampled readouts, mean and 95% CI per metric.

    Every arm run with one cfg sees the same clips (seeded by cfg.run.seed)
    and the same noise (one generator seeded from cfg.run.seed + 1), so
    per-clip `paired_delta`s between arms cancel clip difficulty. Data: the
    `source` with `next(i)` -> (corrupted, original, masks), else the
    on-device synthetic source (`data_texture`, `data_texture_vel`) on the
    modules' device. Returns {"n_clips", "draws", "per_clip", "summary"}."""
    cfg = cfg or Config()
    b = cfg.rl.batch_size
    mods = mods or make_modules(cfg, device=device)
    if state is None:
        state = rl.init_state(cfg, mods.rovr, cfg.run.seed)
    dev = next(mods.raft.parameters()).device
    source = source or rl.DeviceSyntheticSource(cfg, b, data_texture, data_texture_vel,
                                                dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed + 1)
    n_steps = max(1, -(-num_videos // b))  # ceil: at least num_videos clips
    acc: Dict[str, Dict[str, list]] = {"greedy": {}, "sampled": {}}
    for i in range(n_steps):
        corrupted, original, masks = source.next(i)
        res = eval_ci_step(state, mods.rovr, cfg, (corrupted, original, masks),
                           sample_draws, gen)
        for readout, ms in res.items():
            for k, v in ms.items():
                acc[readout].setdefault(k, []).extend(float(x) for x in v.cpu())
    return {
        "n_clips": n_steps * b,
        "draws": sample_draws,
        "per_clip": acc,
        "summary": {readout: {k: summarize(v) for k, v in ms.items()}
                    for readout, ms in acc.items()},
    }


def run(cfg: Optional[Config] = None, dataset=None, num_videos: int = 20,
        state: Optional[rl.ROVRState] = None, flow_size: int = 256, log_cb=None,
        data_texture: float = 0.0, weights: Optional[str] = None,
        init_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        raft_params: Optional[Dict[str, torch.Tensor]] = None,
        source=None, device=None, data_texture_vel: float = 1.5) -> Dict[str, float]:
    """Evaluation entry point: `eval_step` averaged over num_videos //
    cfg.rl.batch_size batches (at least one), written to
    <run_dir>/eval/<timestamp>/metrics.jsonl and returned.

    The metric nets' provenance is derived from what was loaded:
    "converted" only when `raft_params` is given and `init_params` holds
    `lpips_params`; otherwise "random", marked in the result
    (Eval/metric_weights_random and the per-net Eval/{lpips,raft}_weights_
    random) with a warning, because flow recovery and LPIPS under random
    weights exercise the plumbing only. `weights="converted"` against a
    "random" derivation raises. Data: `dataset` items (corrupted, original,
    masks, ...), else `source`, else the on-device synthetic source
    (`data_texture`, `data_texture_vel`)."""
    from rovr_torch.utils.checkpoint import run_dir
    from rovr_torch.utils.logging import MetricsWriter

    cfg = cfg or Config()
    b, s = cfg.rl.batch_size, cfg.rl.vid_length
    if dataset is None and source is None:
        source = rl.DeviceSyntheticSource(cfg, b, data_texture, data_texture_vel, device)
    lpips_random = not (init_params and "lpips_params" in init_params)
    raft_random = raft_params is None
    derived = "random" if (lpips_random or raft_random) else "converted"
    if weights == "converted" and derived != "converted":
        missing = [n for n, r in (("lpips", lpips_random), ("raft", raft_random)) if r]
        raise ValueError(
            "weights='converted' claimed but no converted params were actually "
            f"loaded for: {', '.join(missing)}; pass raft_params and "
            "init_params['lpips_params']")
    weights = derived
    mods = make_modules(cfg, device=device)
    if state is None:
        state = rl.init_state(cfg, mods.rovr, cfg.run.seed, **(init_params or {}))
    if raft_params is None:
        raft_params = init_raft_params(mods, cfg.run.seed)

    writer = MetricsWriter(run_dir(cfg.run.run_dir, "eval"))
    totals: Dict[str, float] = {}
    n_steps = max(1, num_videos // b)
    try:
        for i in range(n_steps):
            if dataset is not None:
                batch = rl.dataset_batch(dataset, i * b, b, s, fields=3)
            else:
                batch = source.next(i)
            metrics = eval_step(state, raft_params, mods, cfg, batch, flow_size)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            if log_cb:
                log_cb(i, metrics)
        means = {k: v / n_steps for k, v in totals.items()}
        means["Eval/metric_weights_random"] = 1.0 if weights == "random" else 0.0
        means["Eval/lpips_weights_random"] = 1.0 if lpips_random else 0.0
        means["Eval/raft_weights_random"] = 1.0 if raft_random else 0.0
        if weights == "random":
            print("[rovr_torch.eval] WARNING: VGG-LPIPS/RAFT weights are RANDOM: "
                  "flow-recovery and LPIPS values exercise the metric plumbing only "
                  "and are not comparable to the poster's numbers. PSNR/SSIM "
                  "(weight-free) remain valid.")
        writer.scalars(means, 0)
    finally:
        writer.close()
    return means
