"""Command line of the PyTorch port: `python -m rovr_torch <cmd> [flags]`
(rovr_tpu/cli.py).

Subcommands `rl` (RL training, `train.rl.run`), `pretrain` (the UNet,
`train.pretrain_local.run`), `imitate` (the warm start of the context
policy, `train.imitation.run`), `pipeline` (pretrain -> imitate -> RL ->
held-out eval, `train.pipeline.run`), `eval` (agentic against sequential
reconstruction, `train.evaluate.run`), `reconstruct` (inference,
`infer.run`) and `convert` (a reference torch checkpoint -> a warm start,
`utils.convert`), with the JAX package's flags and defaults, built on
`Config()` (`pipeline`: on `pipeline.default_config`) as it builds them.
`--device` picks where the port runs: the GPU unless `cpu` is asked for; it
never falls back.

Data: `--root_folder` naming a directory of clip folders is read by the
explicit-teacher reader (`rl`, `imitate`, `eval`) or the random-mask one
(`reconstruct`), as in the JAX CLI; otherwise the drivers draw synthetic
clips made on the device. `pretrain` and `pipeline` read no folder (neither
does the JAX package's) and refuse `--root_folder`. `--warm_start` (`rl`,
`eval`) reads a directory `convert` wrote. `reconstruct --data_parallel N`
(N > 1) serves each batch across N devices: where the JAX CLI is one
process over N devices, this one starts N processes itself, one per device
(NCCL on CUDA devices 0..N-1, or gloo with `--device cpu`), and rank 0
writes the frames; N above the device count (the CPU's cores with
`--device cpu`) or a batch it does not divide is an error, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

from rovr_torch.config import Config

# the init_state keyword arguments a --warm_start directory may plug in
WARM_START_KWARGS = {"local_net_params", "vp_params", "actor2_params", "lpips_params",
                     "critic2_params", "actor1_params", "vp_backbone_params"}


def _base_parser(p: argparse.ArgumentParser) -> None:
    p.add_argument("--root_folder", type=str, default=None,
                   help="frame-folder dataset root (default: synthetic clips)")
    p.add_argument("--run_dir", type=str, default="runs")
    p.add_argument("--restore_from", type=str, default=None,
                   help="checkpoints directory to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_short_dataset", action="store_true",
                   help="truncate the dataset to 10 items")
    p.add_argument("--device", type=str, default=None,
                   help="where to run: the GPU by default, or 'cpu'")


def _apply_base(cfg: Config, args) -> Config:
    data = dataclasses.replace(
        cfg.data, root_folder=args.root_folder or cfg.data.root_folder,
        debug_short_dataset=args.debug_short_dataset)
    run = dataclasses.replace(cfg.run, run_dir=args.run_dir,
                              restore_from=args.restore_from, seed=args.seed)
    return cfg.replace(data=data, run=run)


def _dataset(cfg: Config, args, explicit: bool = True):
    """The folder dataset when --root_folder names a directory, else None
    (the drivers then draw synthetic clips on the device)."""
    from rovr_torch.data.dataset import ExplicitVideoDataset, VideoFolderDataset

    if args.root_folder and os.path.isdir(args.root_folder):
        ds = ExplicitVideoDataset if explicit else VideoFolderDataset
        return ds(cfg.data, seed=cfg.run.seed)
    return None


def _refuse_folder(cmd: str, args) -> None:
    if args.root_folder:
        raise ValueError(
            f"`{cmd}` reads no frame folders: it trains on synthetic clips, as the "
            f"JAX package's `{cmd}` does (it ignores --root_folder); drop --root_folder")


def _warm_start(path: Optional[str], take_raft: bool):
    """(init_state keyword arguments, raft_params if `take_raft`) of a
    `convert` directory, printing what it plugs in and what it skips;
    (None, None) without one."""
    if not path:
        return None, None
    from rovr_torch.utils import convert

    loaded = convert.load_converted(path) or {}
    raft_params = loaded.pop("raft_params", None) if take_raft else None
    init_params = {k: v for k, v in loaded.items() if k in WARM_START_KWARGS}
    for k in sorted(set(loaded) - WARM_START_KWARGS):
        print(f"[warm_start] skipping {k} (no init_state kwarg)")
    print("[warm_start] plugging in: " + ", ".join(
        sorted(init_params) + (["raft_params"] if raft_params is not None else [])))
    return init_params, raft_params


def _print_metrics(tag: str):
    def log(i, m):
        print(f"[{tag} {i}] " + " ".join(f"{k}={float(v):.4f}" for k, v in m.items()),
              flush=True)
    return log


def rl_config(argv: List[str]):
    """(cfg, args) of `rl`'s flags."""
    p = argparse.ArgumentParser("rovr_torch rl")
    p.add_argument("--vid_length", type=int, default=20)
    p.add_argument("--time_steps", type=int, default=20)
    p.add_argument("--n_updates_per_ppo", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=1, help="clips per step")
    p.add_argument("--use_policy1", action="store_true",
                   help="the frame-selection policy pi1 + LSTM picks each target")
    p.add_argument("--ppo_policy1", action="store_true",
                   help="also train pi1/V1 with PPO (implies --use_policy1)")
    p.add_argument("--context_policy", choices=("canvas", "attention"), default="canvas",
                   help="canvas=PolicyNet2, attention=transformer over frame tokens")
    p.add_argument("--sequential_baseline", action="store_true",
                   help="also run the no-grad vid2vid baseline per step (a second "
                        "UNet pass)")
    p.add_argument("--iterations", type=int, default=400, help="hard stop")
    p.add_argument("--warm_start", type=str, default=None,
                   help="directory written by `python -m rovr_torch convert`: its "
                        "state dicts plug into init_state")
    _base_parser(p)
    args = p.parse_args(argv)
    cfg = _apply_base(Config(), args)
    cfg = cfg.replace(
        rl=dataclasses.replace(
            cfg.rl, vid_length=args.vid_length, time_steps=args.time_steps,
            n_updates_per_ppo=args.n_updates_per_ppo, batch_size=args.batch_size,
            use_policy1=args.use_policy1 or args.ppo_policy1,
            ppo_policy1=args.ppo_policy1, context_policy=args.context_policy,
            sequential_baseline=args.sequential_baseline),
        data=dataclasses.replace(cfg.data, vid_length=args.vid_length),
    )
    return cfg, args


def cmd_rl(argv: List[str]) -> int:
    """RL training."""
    cfg, args = rl_config(argv)
    init_params, _ = _warm_start(args.warm_start, take_raft=False)
    from rovr_torch.train import rl

    rl.run(cfg, dataset=_dataset(cfg, args), iterations=args.iterations,
           log_cb=_print_metrics("rl"), init_params=init_params, device=args.device)
    return 0


def pretrain_config(argv: List[str]):
    """(cfg, args) of `pretrain`'s flags."""
    p = argparse.ArgumentParser("rovr_torch pretrain")
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--lr", type=float, default=1e-4)
    _base_parser(p)
    args = p.parse_args(argv)
    cfg = _apply_base(Config(), args)
    cfg = cfg.replace(pretrain=dataclasses.replace(
        cfg.pretrain, steps=args.steps, batch_size=args.batch_size, lr=args.lr))
    return cfg, args


def cmd_pretrain(argv: List[str]) -> int:
    """Local-net UNet pretraining (train_local_net_unet.py)."""
    cfg, args = pretrain_config(argv)
    _refuse_folder("pretrain", args)
    from rovr_torch.train import pretrain_local

    pretrain_local.run(cfg, steps=args.steps, log_cb=_print_metrics("pretrain"),
                       device=args.device)
    return 0


def imitate_config(argv: List[str]):
    """(cfg, args) of `imitate`'s flags."""
    p = argparse.ArgumentParser("rovr_torch imitate")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=2e-4)
    _base_parser(p)
    args = p.parse_args(argv)
    cfg = _apply_base(Config(), args)
    cfg = cfg.replace(imitation=dataclasses.replace(cfg.imitation, steps=args.steps,
                                                    lr=args.lr))
    return cfg, args


def cmd_imitate(argv: List[str]) -> int:
    """Imitation warm start of the context policy (imitation_learning.py)."""
    cfg, args = imitate_config(argv)
    from rovr_torch.train import imitation

    imitation.run(cfg, dataset=_dataset(cfg, args), steps=args.steps,
                  log_cb=_print_metrics("imitate"), device=args.device)
    return 0


def pipeline_config(argv: List[str]):
    """(cfg, args) of `pipeline`'s flags."""
    p = argparse.ArgumentParser("rovr_torch pipeline")
    p.add_argument("--pretrain_steps", type=int, default=2000)
    p.add_argument("--imitation_steps", type=int, default=600,
                   help="teacher accuracy saturates near step 400 at the default scale")
    p.add_argument("--rl_iterations", type=int, default=300)
    p.add_argument("--policy1_iterations", type=int, default=0,
                   help="stage 5: PPO on pi1 for this many iterations (0 = skip), "
                        "then the trained pi1 against a random one")
    p.add_argument("--ppo_from_random_iterations", type=int, default=0,
                   help="stage 3b: also PPO-train a random pi2 and evaluate it")
    p.add_argument("--eval_videos", type=int, default=20)
    p.add_argument("--eval_ci_clips", type=int, default=100,
                   help="stage 4b: per-clip CI eval over this many held-out clips "
                        "per arm; 0 disables")
    p.add_argument("--eval_ci_draws", type=int, default=8,
                   help="sampled-readout draws per clip for the CI eval")
    p.add_argument("--vid_length", type=int, default=20)
    p.add_argument("--rl_batch", type=int, default=4)
    p.add_argument("--texture", type=float, default=1.0,
                   help="mid-frequency texture blend of the synthetic clips")
    p.add_argument("--texture_vel", type=float, default=0.0,
                   help="texture drift px/frame (0 = static)")
    p.add_argument("--log_spatio", action="store_true",
                   help="log the RAFT flow-recovery signal every RL step")
    p.add_argument("--out", type=str, default=None,
                   help="write the full metric record (JSON) here")
    _base_parser(p)
    args = p.parse_args(argv)
    from rovr_torch.train import pipeline

    return _apply_base(pipeline.default_config(args.vid_length, args.rl_batch), args), args


def cmd_pipeline(argv: List[str]) -> int:
    """The learning pipeline: pretrain -> imitate -> RL -> held-out eval."""
    cfg, args = pipeline_config(argv)
    _refuse_folder("pipeline", args)
    from rovr_torch.train import pipeline

    pipeline.run(
        cfg, pretrain_steps=args.pretrain_steps, imitation_steps=args.imitation_steps,
        rl_iterations=args.rl_iterations, policy1_iterations=args.policy1_iterations,
        ppo_from_random_iterations=args.ppo_from_random_iterations,
        eval_videos=args.eval_videos, eval_ci_clips=args.eval_ci_clips,
        eval_ci_draws=args.eval_ci_draws, texture=args.texture,
        texture_vel=args.texture_vel, log_spatio=args.log_spatio, out_path=args.out,
        device=args.device)
    return 0


def eval_config(argv: List[str]):
    """(cfg, args) of `eval`'s flags."""
    p = argparse.ArgumentParser("rovr_torch eval")
    p.add_argument("--num_videos", type=int, default=20, help="rollouts to average")
    p.add_argument("--vid_length", type=int, default=20)
    p.add_argument("--flow_size", type=int, default=256)
    p.add_argument("--warm_start", type=str, default=None,
                   help="directory written by `python -m rovr_torch convert`: its "
                        "lpips_params/raft_params become the metric nets (the only "
                        "way the weight-dependent metrics print without --force) and "
                        "its model state dicts plug into init_state")
    p.add_argument("--force", action="store_true",
                   help="print the weight-dependent metrics (flow_recovery_*, "
                        "lpips_*) even under random metric weights")
    _base_parser(p)
    args = p.parse_args(argv)
    cfg = _apply_base(Config(), args)
    cfg = cfg.replace(
        rl=dataclasses.replace(cfg.rl, vid_length=args.vid_length,
                               time_steps=args.vid_length),
        data=dataclasses.replace(cfg.data, vid_length=args.vid_length),
    )
    return cfg, args


def cmd_eval(argv: List[str]) -> int:
    """Reconstruction eval: agentic against sequential flow recovery."""
    cfg, args = eval_config(argv)
    init_params, raft_params = _warm_start(args.warm_start, take_raft=True)
    from rovr_torch.train import evaluate

    means = evaluate.run(cfg, dataset=_dataset(cfg, args), num_videos=args.num_videos,
                         flow_size=args.flow_size, init_params=init_params,
                         raft_params=raft_params, device=args.device)
    # Random metric weights: flow recovery and LPIPS are not comparable to
    # the poster's numbers, so they print only with --force. evaluate.run
    # derives the mark from what was loaded.
    untrusted = means.get("Eval/metric_weights_random", 1.0) == 1.0 and not args.force
    withheld = []
    for k, v in sorted(means.items()):
        if untrusted and ("flow_recovery" in k or "/lpips" in k):
            withheld.append(k)
            continue
        print(f"{k}: {v:.4f}")
    if withheld:
        print(f"[rovr_torch.eval] {len(withheld)} weight-dependent metrics withheld "
              "(random VGG/RAFT weights; not poster-comparable). Pass --force to "
              "print them, or load converted weights with --warm_start "
              "(convert --kind vgg_lpips / raft).")
    return 0


def reconstruct_config(argv: List[str]):
    """(cfg, args) of `reconstruct`'s flags."""
    p = argparse.ArgumentParser("rovr_torch reconstruct")
    p.add_argument("--num_clips", type=int, default=4)
    p.add_argument("--vid_length", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--context_policy", choices=("canvas", "attention"), default="canvas")
    p.add_argument("--out", type=str, default="reconstructed")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard the clip batch over this many devices, one process each "
                        "(0 = single device); batch_size must divide by it")
    _base_parser(p)
    args = p.parse_args(argv)
    if args.data_parallel > 1:
        from rovr_torch.parallel.launch import device_count

        n = device_count("cpu" if args.device == "cpu" else "cuda")
        if args.data_parallel > n:
            p.error(f"--data_parallel {args.data_parallel} > {n} devices")
        if args.batch_size % args.data_parallel:
            p.error(f"--batch_size {args.batch_size} not divisible by "
                    f"--data_parallel {args.data_parallel}")
    cfg = _apply_base(Config(), args)
    cfg = cfg.replace(
        rl=dataclasses.replace(
            cfg.rl, vid_length=args.vid_length, time_steps=args.vid_length,
            batch_size=args.batch_size, context_policy=args.context_policy),
        data=dataclasses.replace(cfg.data, vid_length=args.vid_length),
    )
    return cfg, args


def cmd_reconstruct(argv: List[str]) -> int:
    """Inference: reconstruct corrupted clips with a trained checkpoint and
    write frames as <out>/<clip>/<frame>.png."""
    cfg, args = reconstruct_config(argv)
    if args.data_parallel > 1:
        from rovr_torch.parallel import launch

        launch.spawn(_reconstruct_rank, args.data_parallel,
                     "cpu" if args.device == "cpu" else "cuda", args=(cfg, args))
        return 0
    _reconstruct_rank(None, cfg, args)
    return 0


def _reconstruct_rank(mesh, cfg: Config, args) -> None:
    """`reconstruct` on one device, or as one rank of a data mesh (rank 0
    prints the summary)."""
    from rovr_torch import infer

    summary = infer.run(cfg, restore_from=args.restore_from,
                        dataset=_dataset(cfg, args, explicit=False),
                        num_clips=args.num_clips, out_dir=args.out,
                        device=args.device if mesh is None else None, mesh=mesh)
    if mesh is not None:
        summary["data_parallel"] = mesh.size
        if not mesh.first:
            return
    for k, v in summary.items():
        print(f"{k}: {v}", flush=True)


def cmd_convert(argv: List[str]) -> int:
    """A reference torch checkpoint -> a warm-start directory for
    `--warm_start` (utils.convert): local_net (the UNet pretrain), policy2
    (imitation), policy1, rovr (the full RL state), and the pretrained
    metric nets (torchvision resnet50 / raft_small, pip lpips' VGG)."""
    from rovr_torch.utils import convert

    p = argparse.ArgumentParser("rovr_torch convert")
    p.add_argument("--kind", choices=convert.KINDS, required=True)
    p.add_argument("--ckpt", type=str, required=True,
                   help="torch .pt/.pth checkpoint or state-dict file")
    p.add_argument("--out", type=str, required=True,
                   help="output directory (a step-0 checkpoint, torch.save); state "
                        "dicts already converted there are kept")
    args = p.parse_args(argv)

    init_params, report = convert.convert_reference_checkpoint(args.kind, args.ckpt)
    for name in report["converted"]:
        print(f"[convert] converted: {name}")
    for note in report["skipped"]:
        print(f"[convert] skipped: {note}")
    if not init_params:
        print("[convert] nothing converted: wrong --kind for this file?")
        return 1
    if os.path.isdir(args.out):   # a second kind joins the first (e.g. vgg_lpips + raft)
        kept = {k: v for k, v in (convert.load_converted(args.out) or {}).items()
                if k not in init_params}
        if kept:
            print(f"[convert] keeping from {args.out}: {sorted(kept)}")
        init_params = {**kept, **init_params}
    print(f"[convert] written to {convert.save_converted(args.out, init_params)}")
    return 0


COMMANDS = {"rl": cmd_rl, "pretrain": cmd_pretrain, "imitate": cmd_imitate,
            "eval": cmd_eval, "pipeline": cmd_pipeline, "reconstruct": cmd_reconstruct,
            "convert": cmd_convert}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rovr_torch {" + ",".join(COMMANDS) + "} [flags]")
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}; choose from {list(COMMANDS)}")
        return 2
    return COMMANDS[cmd](argv[1:])
