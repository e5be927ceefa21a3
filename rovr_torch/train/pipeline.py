"""End-to-end learning pipeline: UNet pretrain -> imitation warm start ->
PPO -> held-out evaluation, each stage's parameters threaded into the next
(rovr_tpu/train/pipeline.py, PyTorch port).

The original chains three scripts by hand-edited checkpoint paths
(rovr.py:37-42); here each stage returns its state and the next plugs the
parameters in by argument (rl.init_state's warm-start arguments). On
textured synthetic clips of the raster-box scheme it shows: the pretrain
loss falling, the imitation top-2 accuracy rising, PPO running from the
warm start, and the held-out agentic reconstruction against the sequential
baseline and against a random-policy control, with paired 95% intervals
(`evaluate.run_ci`, `paired_delta`). All numbers ride on PSNR/MSE, which
need no pretrained weights; LPIPS and flow values under random weights are
marked as such (evaluate.run weights="random").

Stage 5 (`policy1_iterations > 0`) trains the frame-selection policy π₁ by
PPO from stage 3's π₂ and holds it against a fresh, random π₁ on held-out
clips.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from rovr_torch.config import Config


def _collect(curve: List[Dict[str, float]]):
    """log_cb that appends (step, metrics) rows to `curve`."""

    def cb(i, metrics):
        curve.append({"step": int(i), **{k: float(v) for k, v in metrics.items()}})

    return cb


def default_config(vid_length: int = 20, rl_batch: int = 4, frame: int = 160) -> Config:
    """The pipeline's configuration (the JAX package's, field for field):
    160^2 frames, where the fixed 150x100 raster boxes leave learned context
    selection visible (random context pairs expose 0.79 of a target's hole,
    sequential ones 0.30); the attention context policy; every stage on the
    raster scheme with overlap-free boxes; the backbone pooled to a 4 x 4
    grid, so features keep the masks' positions under random weights; and
    imitation by canonical-pair CE."""
    c = Config()
    return c.replace(
        rl=dataclasses.replace(
            c.rl, vid_length=vid_length, time_steps=vid_length, batch_size=rl_batch,
            context_policy="attention",
        ),
        data=dataclasses.replace(c.data, vid_length=vid_length, frame_size=(frame, frame),
                                 synthetic_overlap_free=True, synthetic_scheme="raster"),
        model=dataclasses.replace(c.model, backbone_spatial_pool=4),
        imitation=dataclasses.replace(c.imitation, loss_mode="pair_ce"),
        run=dataclasses.replace(c.run, checkpoint_every=50, log_every=5),
    )


def _curve_avg(rows, key, n):
    """Mean of `key` over the last n rows (n > 0) or all but the last -n."""
    vals = [r[key] for r in rows if key in r]
    vals = vals[-n:] if n > 0 else vals[:-n]
    return sum(vals) / max(1, len(vals))


def pretrain_data(cfg: Config, pretrain_clips: int, texture: float, texture_vel: float,
                  device):
    """(video, orig, positives): pretrain_clips // 4 (at least one) batches of
    4 clips of the device source (seed cfg.run.seed + 77) cut to
    cfg.rl.vid_length frames, with exposing context pairs per target: the
    explicit scheme's teacher positives, or the raster scheme's fully
    exposing pairs (the same for every clip)."""
    from rovr_torch.data.device_synthetic import (
        check_source_frames, make_source, raster_positive_pairs,
    )

    h, w = cfg.data.frame_size
    s = cfg.rl.vid_length
    check_source_frames(s)
    src = make_source(cfg, 4, cfg.run.seed + 77, texture, texture_vel, device)
    raster_pos = None
    if cfg.data.synthetic_scheme == "raster":
        raster_pos = torch.from_numpy(raster_positive_pairs(s, h, w, seed=cfg.run.seed))
    vids, origs, poss = [], [], []
    for i in range(max(1, pretrain_clips // 4)):
        corrupted, original, _, positives, _ = src.next(i)
        vids.append(corrupted[:, :s])
        origs.append(original[:, :s])
        if positives is None:
            pos = raster_pos[None].expand((4,) + tuple(raster_pos.shape))
        else:
            pos = torch.from_numpy(positives[:, :s])
        poss.append(pos.to(device=corrupted.device, dtype=torch.int32))
    return torch.cat(vids), torch.cat(origs), torch.cat(poss)


def run(
    cfg: Optional[Config] = None,
    pretrain_steps: int = 2000,
    imitation_steps: int = 600,
    rl_iterations: int = 300,
    eval_videos: int = 20,
    texture: float = 1.0,
    texture_vel: float = 0.0,
    pretrain_clips: int = 32,
    out_path: Optional[str] = None,
    policy1_iterations: int = 0,
    ppo_from_random_iterations: int = 0,
    log_spatio: bool = False,
    eval_ci_clips: int = 100,
    eval_ci_draws: int = 8,
    device=None,
) -> Dict[str, Any]:
    """Run the stages and return (and with `out_path` write as JSON) the
    record: each stage's metric curve, the held-out eval of the trained
    policy, of the warm start alone, of a random-policy control (the same
    pretrained UNet, an untrained actor) and, with
    `ppo_from_random_iterations` > 0, of PPO from a random π₂ (stage 3b);
    `ppo_ablation`, their differences; with `eval_ci_clips` > 0 the per-clip
    CI eval of every arm and `ablation_ci`, their paired deltas; with
    `policy1_iterations` > 0 stage 5 (`policy1`, `policy1_summary`,
    `policy1_control`, see `_stage5`). Every stage runs on CUDA unless
    `device="cpu"`."""
    from rovr_torch.device import resolve
    from rovr_torch.train import evaluate, imitation, pretrain_local, rl

    cfg = cfg or default_config()
    dev = resolve(device)
    record: Dict[str, Any] = {
        "config": {
            "vid_length": cfg.rl.vid_length,
            "time_steps": cfg.rl.time_steps,
            "rl_batch": cfg.rl.batch_size,
            "frame_size": list(cfg.data.frame_size),
            "texture": texture,
            "texture_vel": texture_vel,
            "pretrain_steps": pretrain_steps,
            "imitation_steps": imitation_steps,
            "rl_iterations": rl_iterations,
            "eval_videos": eval_videos,
            "eval_ci_clips": eval_ci_clips,
            "eval_ci_draws": eval_ci_draws,
            "policy1_iterations": policy1_iterations,
            "ppo_from_random_iterations": ppo_from_random_iterations,
        }
    }
    t0 = time.time()

    # ---- Stage 1: UNet pretrain on the distribution RL will see, half the
    # samples with exposing context pairs (pretrain_local.sample_batch)
    data = pretrain_data(cfg, pretrain_clips, texture, texture_vel, dev)
    pre_curve: List[Dict[str, float]] = []
    state_p = pretrain_local.run(cfg, data=data, steps=pretrain_steps,
                                 log_cb=_collect(pre_curve), device=dev)
    record["pretrain"] = pre_curve
    print(f"[pipeline] pretrain done in {time.time() - t0:.0f}s: "
          f"first total {pre_curve[0]['Loss/total_loss']:.4f} -> "
          f"last {pre_curve[-1]['Loss/total_loss']:.4f}")

    # ---- Stage 2: imitation warm start of the context policy
    t1 = time.time()
    im_curve: List[Dict[str, float]] = []
    state_i = imitation.run(cfg, steps=imitation_steps, log_cb=_collect(im_curve),
                            data_texture=texture, data_texture_vel=texture_vel, device=dev)
    record["imitation"] = im_curve
    print(f"[pipeline] imitation done in {time.time() - t1:.0f}s: "
          f"top2_acc {im_curve[0].get('Imitation/top2_acc', 0):.3f} -> "
          f"{im_curve[-1].get('Imitation/top2_acc', 0):.3f}")

    # ---- Stage 3: PPO from the warm start; the pretrain stage's LPIPS
    # parameters become the reward metric
    t2 = time.time()
    rl_curve: List[Dict[str, float]] = []
    warm = dict(local_net_params=state_p.params, lpips_params=state_p.lpips_params,
                vp_params=state_i.vp_params, actor2_params=state_i.pn2_params)
    cfg_rl = cfg
    if log_spatio:  # the RAFT signal of this stage only: the most costly metric
        cfg_rl = cfg.replace(rl=dataclasses.replace(
            cfg.rl, log_spatio=True, spatio_flow_size=rl.resolved_flow_size(cfg)))
        record["config"]["log_spatio"] = True
        record["config"]["spatio_flow_size"] = cfg_rl.rl.spatio_flow_size
    rl_state = rl.run(cfg_rl, iterations=rl_iterations, log_cb=_collect(rl_curve),
                      init_params=warm, data_texture=texture,
                      data_texture_vel=texture_vel, device=dev)
    record["rl"] = rl_curve
    print(f"[pipeline] RL done in {time.time() - t2:.0f}s: "
          f"mean_reward {rl_curve[0]['Episode/mean_reward']:.4f} -> "
          f"{rl_curve[-1]['Episode/mean_reward']:.4f}")

    # ---- Stage 3b: PPO from a RANDOM π₂ (the same pretrained UNet, LPIPS
    # and VideoProcessor as the control arm, no imitation): what PPO's
    # reward alone lifts
    rl_state_rnd = None
    if ppo_from_random_iterations > 0:
        t2b = time.time()
        rnd_curve: List[Dict[str, float]] = []
        warm_rnd = {k: v for k, v in warm.items() if k != "actor2_params"}
        rl_state_rnd = rl.run(cfg, iterations=ppo_from_random_iterations,
                              log_cb=_collect(rnd_curve), init_params=warm_rnd,
                              data_texture=texture, data_texture_vel=texture_vel,
                              device=dev)
        record["rl_from_random"] = rnd_curve
        print(f"[pipeline] PPO-from-random done in {time.time() - t2b:.0f}s: "
              f"exposure {_curve_avg(rnd_curve, 'Episode/exposure', -10):.3f} -> "
              f"{_curve_avg(rnd_curve, 'Episode/exposure', 10):.3f}; mean_reward "
              f"{rnd_curve[0]['Episode/mean_reward']:.4f} -> "
              f"{rnd_curve[-1]['Episode/mean_reward']:.4f}")

    # ---- Stage 4: held-out eval of every arm on the SAME eval seeds and
    # clips, the sequential baseline riding along
    t3 = time.time()
    eval_cfg = cfg.replace(run=dataclasses.replace(cfg.run, seed=cfg.run.seed + 10_000))
    mods_eval = evaluate.make_modules(eval_cfg, device=dev)
    ctrl = {k: v for k, v in warm.items() if k != "actor2_params"}
    control_state = rl.init_state(eval_cfg, mods_eval.rovr, cfg.run.seed + 5, **ctrl)
    # warm-start-only: the stage-2 outputs that seeded stage 3, the critic
    # fresh (it never acts in eval)
    warm_only_state = rl.init_state(eval_cfg, mods_eval.rovr, cfg.run.seed + 5, **warm)
    arms = {"trained": rl_state, "warm_start_only": warm_only_state,
            "random_policy": control_state}
    if rl_state_rnd is not None:
        arms["ppo_from_random"] = rl_state_rnd
    for name, st in arms.items():
        record[f"eval_{name}"] = evaluate.run(
            eval_cfg, num_videos=eval_videos, state=st, data_texture=texture,
            data_texture_vel=texture_vel, weights="random", device=dev)

    def _delta(a: Dict[str, float], b: Dict[str, float], key: str) -> float:
        return float(a.get(key, float("nan")) - b.get(key, float("nan")))

    keys = ("Eval/masked_psnr_agentic", "Eval/exposure_agentic", "Eval/psnr_agentic")
    abl: Dict[str, Any] = {"ppo_on_warm_start": {
        k: _delta(record["eval_trained"], record["eval_warm_start_only"], k) for k in keys}}
    if rl_state_rnd is not None:
        abl["ppo_from_random_vs_random"] = {
            k: _delta(record["eval_ppo_from_random"], record["eval_random_policy"], k)
            for k in keys}
        abl["warm_start_vs_random"] = {
            k: _delta(record["eval_warm_start_only"], record["eval_random_policy"], k)
            for k in keys}
    record["ppo_ablation"] = abl

    # ---- Stage 4b: the CI eval: every arm on the same held-out clips and
    # noise, per-clip greedy and sampled readouts, paired 95% t-intervals
    if eval_ci_clips > 0:
        t3b = time.time()
        record["eval_ci"] = {
            name: evaluate.run_ci(eval_cfg, state=st, num_videos=eval_ci_clips,
                                  sample_draws=eval_ci_draws, data_texture=texture,
                                  data_texture_vel=texture_vel, mods=mods_eval)
            for name, st in arms.items()
        }
        pc = {name: r["per_clip"] for name, r in record["eval_ci"].items()}

        def _pair(a_arm, b_arm, readout, key_a, key_b=None):
            return evaluate.paired_delta(pc[a_arm][readout][key_a],
                                         pc[b_arm][readout][key_b or key_a])

        ci: Dict[str, Any] = {}
        for readout in ("greedy", "sampled"):
            t = {}
            for key in ("masked_psnr_agentic", "exposure_agentic", "psnr_agentic"):
                row = {
                    "trained_vs_random": _pair("trained", "random_policy", readout, key),
                    "ppo_on_warm_start": _pair("trained", "warm_start_only", readout, key),
                    "warm_start_vs_random": _pair("warm_start_only", "random_policy",
                                                  readout, key),
                }
                if rl_state_rnd is not None:
                    row["ppo_from_random_vs_random"] = _pair(
                        "ppo_from_random", "random_policy", readout, key)
                t[key] = row
            # agentic against the deterministic sequential baseline within the
            # trained arm (the poster's headline); the sequential output does
            # not depend on the readout, so it pairs against the greedy list
            t["masked_psnr_agentic"]["trained_agentic_vs_sequential"] = (
                evaluate.paired_delta(pc["trained"][readout]["masked_psnr_agentic"],
                                      pc["trained"]["greedy"]["masked_psnr_sequential"]))
            ci[readout] = t
        record["ablation_ci"] = ci

        def _fmt(d):
            sep = "SEPARATES" if d["separates"] else "within CI"
            return f"{d['mean']:+.3f} ± {d['ci95']:.3f} ({sep})"

        print(f"[pipeline] CI eval done in {time.time() - t3b:.0f}s "
              f"(n={record['eval_ci']['trained']['n_clips']} clips, "
              f"K={eval_ci_draws} draws); masked-PSNR deltas (dB):")
        for readout in ("greedy", "sampled"):
            rows = ci[readout]["masked_psnr_agentic"]
            print(f"  [{readout}] " + "  ".join(f"{k}: {_fmt(v)}" for k, v in rows.items()))

    if policy1_iterations > 0:
        record.update(_stage5(cfg, warm, rl_state, policy1_iterations, texture,
                              texture_vel, eval_ci_clips, dev))

    record["wall_seconds"] = time.time() - t0
    et, er = record["eval_trained"], record["eval_random_policy"]
    ew = record["eval_warm_start_only"]
    ep = record.get("eval_ppo_from_random")
    mp = "Eval/masked_psnr_agentic"
    nan = float("nan")
    print(f"[pipeline] eval done in {time.time() - t3:.0f}s:\n"
          f"  masked PSNR  warm+PPO {et.get(mp, nan):.3f}  warm-only {ew.get(mp, nan):.3f}"
          f"  PPO-from-random {ep.get(mp, nan) if ep else nan:.3f}"
          f"  random-policy {er.get(mp, nan):.3f}"
          f"  sequential {et.get('Eval/masked_psnr_sequential', nan):.3f}"
          f"  corrupted {et.get('Eval/masked_psnr_corrupted', nan):.3f}\n"
          f"  PSNR         agentic(trained) {et['Eval/psnr_agentic']:.3f}"
          f"  sequential {et['Eval/psnr_sequential']:.3f}"
          f"  corrupted {et['Eval/psnr_corrupted']:.3f}\n"
          f"  ppo_ablation {json.dumps(record['ppo_ablation'])}")

    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"[pipeline] record written to {out_path}")
    return record


def _stage5(cfg: Config, warm: Dict[str, Any], rl_state, iterations: int, texture: float,
            texture_vel: float, eval_ci_clips: int, dev) -> Dict[str, Any]:
    """Stage 5: PPO on the frame-selection policy π₁ (use_policy1,
    ppo_policy1) from stage 3's trained π₂, π₁, V₁ and the LSTM fresh; then
    the trained π₁ against a fresh random π₁ (seed + 6, the same π₂) on the
    same held-out clips (the device source at seed + 10000) with the same
    noise for both arms of a batch: per-clip coverage (distinct targets /
    steps) and return, paired 95% intervals. Returns the record's
    `policy1`, `policy1_summary` and `policy1_control`."""
    from rovr_torch.data.device_synthetic import make_source
    from rovr_torch.models.policy_net_1 import gumbel_noise
    from rovr_torch.train import evaluate, rl

    t4 = time.time()
    p1_cfg = cfg.replace(rl=dataclasses.replace(cfg.rl, use_policy1=True, ppo_policy1=True))
    curve: List[Dict[str, float]] = []
    warm5 = dict(warm, actor2_params=rl_state.actor2_params)
    p1_state = rl.run(p1_cfg, iterations=iterations, log_cb=_collect(curve),
                      init_params=warm5, data_texture=texture,
                      data_texture_vel=texture_vel, device=dev)
    s_frames, t_steps = p1_cfg.rl.vid_length, p1_cfg.rl.time_steps
    summary = {
        "coverage_first10": _curve_avg(curve, "Episode/coverage", -10),
        "coverage_last10": _curve_avg(curve, "Episode/coverage", 10),
        "return_first10": _curve_avg(curve, "Episode/return", -10),
        "return_last10": _curve_avg(curve, "Episode/return", 10),
        "coverage_random_expected": (
            (1.0 - (1.0 - 1.0 / s_frames) ** t_steps) * s_frames / t_steps),
    }

    mods = rl.make_modules(p1_cfg, device=dev)
    ctrl_state = rl.init_state(p1_cfg, mods, cfg.run.seed + 6, **warm5)
    ctrl_cfg = p1_cfg.replace(run=dataclasses.replace(p1_cfg.run,
                                                      seed=cfg.run.seed + 10_000))
    b = p1_cfg.rl.batch_size
    n_ctrl = max(1, -(-eval_ci_clips // b)) if eval_ci_clips > 0 else 8
    src = make_source(ctrl_cfg, b, ctrl_cfg.run.seed, texture, texture_vel, dev)
    arms = {"trained": p1_state, "random_policy1": ctrl_state}
    cov: Dict[str, List[float]] = {k: [] for k in arms}
    ret: Dict[str, List[float]] = {k: [] for k in arms}
    for i in range(n_ctrl):
        corrupted, original, _, _, _ = src.next(i)
        v, o = corrupted[:, :s_frames], original[:, :s_frames]
        gen = torch.Generator(device=v.device).manual_seed(ctrl_cfg.run.seed + 2 + i)
        noise = gumbel_noise((t_steps, b, s_frames), gen, v.device)
        noise1 = gumbel_noise((t_steps, b, p1_cfg.model.pn1_num_frames), gen, v.device)
        for name, st in arms.items():
            out = rl.rollout(st, mods, p1_cfg, v, o, gumbel=noise, gumbel1=noise1)
            tgt = out.traj.target_idx                                   # (T, B)
            distinct = torch.nn.functional.one_hot(tgt, s_frames).any(0).sum(1)
            cov[name].extend((distinct / t_steps).tolist())
            ret[name].extend(out.traj.rtgs[0].float().tolist())
    cov_d = evaluate.paired_delta(cov["trained"], cov["random_policy1"])
    ret_d = evaluate.paired_delta(ret["trained"], ret["random_policy1"])
    control = {
        "n_clips": n_ctrl * b,
        "coverage": {name: evaluate.summarize(cov[name]) for name in arms},
        "return": {name: evaluate.summarize(ret[name]) for name in arms},
    }
    control["coverage"]["delta"] = cov_d
    control["return"]["delta"] = ret_d
    summary["coverage_random_measured"] = control["coverage"]["random_policy1"]["mean"]
    summary["separates_from_random"] = bool(cov_d["separates"] and cov_d["mean"] > 0)
    summary["verdict"] = (
        "trained pi1 separates from the random-pi1 control"
        if summary["separates_from_random"]
        else "CHANCE-LEVEL: trained pi1 does not separate from the random-pi1 control "
             "on held-out clips")
    print(f"[pipeline] policy1 RL done in {time.time() - t4:.0f}s: coverage "
          f"{summary['coverage_first10']:.3f} -> {summary['coverage_last10']:.3f} (random "
          f"{summary['coverage_random_expected']:.3f}, ceiling 1.0); return "
          f"{summary['return_first10']:.3f} -> {summary['return_last10']:.3f}")
    print(f"[pipeline] policy1 control (n={n_ctrl * b}): coverage trained "
          f"{cov_d['mean']:+.3f} ± {cov_d['ci95']:.3f} vs random-pi1; return "
          f"{ret_d['mean']:+.3f} ± {ret_d['ci95']:.3f}; {summary['verdict']}")
    return {"policy1": curve, "policy1_summary": summary, "policy1_control": control}
