"""The port's command line (rovr_torch/cli.py, `python -m rovr_torch`).

The same argv must build the same config as `rovr_tpu.cli` (compared as
`dataclasses.asdict`, with the JAX entry points stubbed out to catch it); the
unported flags and subcommands must refuse; `rl` then `reconstruct
--restore_from`, and `pretrain` and `imitate`, run end to end on the CPU, on
a tiny config put in place of `Config()`; `pipeline` hands its flags to
`pipeline.run`.
"""

import dataclasses
import glob
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu import cli as jcli
from rovr_torch import cli as tcli
from rovr_torch.config import from_dict


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent

ARGVS = {
    "rl": [[], ["--vid_length", "12", "--time_steps", "8", "--n_updates_per_ppo", "3",
                "--batch_size", "4", "--context_policy", "attention",
                "--sequential_baseline", "--iterations", "7", "--run_dir", "r",
                "--seed", "5", "--root_folder", "no_such_dir", "--debug_short_dataset"],
           ["--use_policy1"], ["--ppo_policy1", "--context_policy", "attention"]],
    "eval": [[], ["--num_videos", "8", "--vid_length", "6", "--flow_size", "64",
                  "--restore_from", "ck", "--force", "--seed", "2"]],
    "reconstruct": [[], ["--num_clips", "3", "--vid_length", "9", "--batch_size", "3",
                         "--context_policy", "attention", "--out", "o", "--data_parallel",
                         "1", "--restore_from", "ck"]],
    "pretrain": [[], ["--steps", "7", "--batch_size", "5", "--lr", "3e-4", "--seed", "2",
                      "--run_dir", "r", "--restore_from", "ck"]],
    "imitate": [[], ["--steps", "9", "--lr", "1e-3", "--seed", "4", "--debug_short_dataset"]],
    "pipeline": [[], ["--pretrain_steps", "3", "--imitation_steps", "4", "--rl_iterations",
                      "5", "--ppo_from_random_iterations", "2", "--eval_videos", "6",
                      "--eval_ci_clips", "8", "--eval_ci_draws", "3", "--vid_length", "12",
                      "--rl_batch", "3", "--texture", "0.5", "--texture_vel", "1.0",
                      "--log_spatio", "--out", "rec.json", "--seed", "7"]],
}
JAX_ENTRY = {"rl": ("rovr_tpu.train.rl", "run"),
              "eval": ("rovr_tpu.train.evaluate", "run"),
              "reconstruct": ("rovr_tpu.infer", "run"),
              "pretrain": ("rovr_tpu.train.pretrain_local", "run"),
              "imitate": ("rovr_tpu.train.imitation", "run"),
              "pipeline": ("rovr_tpu.train.pipeline", "run")}


def _jax_cfg(monkeypatch, cmd, argv):
    seen = []
    mod, name = JAX_ENTRY[cmd]
    monkeypatch.setattr(f"{mod}.{name}", lambda cfg, *a, **kw: seen.append(cfg) or {})
    assert jcli.main([cmd] + argv) == 0
    return seen[0]


@pytest.mark.parametrize("cmd", sorted(ARGVS))
def test_same_argv_builds_the_jax_config(monkeypatch, cmd):
    build = {"rl": tcli.rl_config, "eval": tcli.eval_config,
             "reconstruct": tcli.reconstruct_config, "pretrain": tcli.pretrain_config,
             "imitate": tcli.imitate_config, "pipeline": tcli.pipeline_config}[cmd]
    for argv in ARGVS[cmd]:
        cfg_j = _jax_cfg(monkeypatch, cmd, argv)
        cfg_t, args = build(argv + ["--device", "cpu"])
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j), (cmd, argv)
        assert args.device == "cpu"


def test_unported_flags_and_commands_refuse(tmp_path, capsys, monkeypatch):
    # pi1 is ported: `pipeline --policy1_iterations` hands stage 5 its count
    seen = {}
    monkeypatch.setattr("rovr_torch.train.pipeline.run",
                        lambda cfg, **kw: seen.update(kw) or {})
    assert tcli.main(["pipeline", "--policy1_iterations", "3", "--device", "cpu"]) == 0
    assert seen["policy1_iterations"] == 3 and seen["device"] == "cpu"
    # data-parallel serving runs (test_reconstruct_data_parallel_on_the_cpu);
    # more processes than devices is an error, as in the JAX CLI (no GPU here)
    with pytest.raises(SystemExit) as e:
        tcli.main(["reconstruct", "--data_parallel", "2"])
    assert e.value.code == 2
    # pretrain and pipeline read no frame folders (nor do the JAX package's)
    for cmd in ("pretrain", "pipeline"):
        with pytest.raises(ValueError, match="reads no frame folders"):
            tcli.main([cmd, "--root_folder", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        tcli.main(["convert", "--help"])
    assert e.value.code == 0
    assert "--kind" in capsys.readouterr().out
    assert tcli.main(["nonsense"]) == 2
    assert tcli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "convert" in out and "not ported yet" not in out


def test_python_dash_m_help():
    out = subprocess.run([sys.executable, "-m", "rovr_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert "usage: python -m rovr_torch {rl,pretrain,imitate,eval,pipeline,reconstruct," \
        "convert}" in out.stdout


def test_rl_then_reconstruct_restored_on_the_cpu(monkeypatch, tmp_path, capsys):
    """`rl` writes metrics and a checkpoint; `reconstruct --restore_from` it
    writes frames and reports restored; `eval` withholds the weight-dependent
    metrics without --force."""
    c = _tiny_config(batch_size=2)
    tiny = from_dict(dataclasses.asdict(c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides()))))
    monkeypatch.setattr(tcli, "Config", lambda: tiny)
    run_dir = tmp_path / "runs"
    assert tcli.main(["rl", "--iterations", "1", "--batch_size", "2", "--vid_length", "5",
                      "--time_steps", "4", "--n_updates_per_ppo", "1", "--run_dir",
                      str(run_dir), "--device", "cpu"]) == 0
    assert "[rl 0] Episode/lpips_loss=" in capsys.readouterr().out
    (ck,) = glob.glob(str(run_dir / "rovr_rl" / "*" / "checkpoints"))
    assert os.listdir(ck) == ["0"]
    out_dir = tmp_path / "frames"
    assert tcli.main(["reconstruct", "--restore_from", ck, "--num_clips", "2",
                      "--vid_length", "5", "--out", str(out_dir), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "restored: True" in printed and "frames_written: 10" in printed
    assert len(glob.glob(str(out_dir / "*" / "*.png"))) == 10
    assert tcli.main(["eval", "--num_videos", "2", "--vid_length", "5", "--flow_size", "64",
                      "--run_dir", str(run_dir), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("Eval/psnr_agentic:") for line in lines)
    assert not any(line.startswith(("Eval/flow_recovery", "Eval/lpips")) for line in lines)
    assert any("4 weight-dependent metrics withheld" in line for line in lines)


def test_reconstruct_data_parallel_on_the_cpu(monkeypatch, tmp_path, capfd):
    """`reconstruct --data_parallel 2 --device cpu` starts two gloo processes
    and writes the frames `--data_parallel 1` writes (uint8 within 1 LSB:
    the batch statistics are summed across the ranks); more processes than
    the CPU has cores, or a batch the count does not divide, is an error."""
    import cv2
    import numpy as np

    c = _tiny_config(batch_size=2)
    tiny = from_dict(dataclasses.asdict(c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides()))))
    monkeypatch.setattr(tcli, "Config", lambda: tiny)
    outs = {}
    for n in (1, 2):
        outs[n] = tmp_path / f"dp{n}"
        assert tcli.main(["reconstruct", "--num_clips", "4", "--batch_size", "2",
                          "--vid_length", "5", "--out", str(outs[n]), "--data_parallel",
                          str(n), "--device", "cpu"]) == 0
    printed = capfd.readouterr().out
    assert "frames_written: 20" in printed and "data_parallel: 2" in printed
    names = sorted(os.path.relpath(p, outs[1]) for p in glob.glob(str(outs[1] / "*" / "*.png")))
    assert len(names) == 20
    assert names == sorted(os.path.relpath(p, outs[2])
                           for p in glob.glob(str(outs[2] / "*" / "*.png")))
    for name in names:
        a, b = (cv2.imread(str(outs[n] / name)).astype(int) for n in (1, 2))
        assert np.abs(a - b).max() <= 1, name
    for argv in (["--data_parallel", str(10 * (os.cpu_count() or 1))],
                 ["--data_parallel", "2", "--batch_size", "3"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(["reconstruct", "--device", "cpu"] + argv)
        assert e.value.code == 2


def test_rl_ppo_policy1_on_the_cpu(monkeypatch, tmp_path, capsys):
    """`rl --ppo_policy1` trains pi1 (use_policy1 follows) and logs its PPO
    losses beside pi2's."""
    c = _tiny_config(batch_size=2)
    tiny = from_dict(dataclasses.asdict(c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), lstm_hidden_dim=32))))
    monkeypatch.setattr(tcli, "Config", lambda: tiny)
    cfg, _ = tcli.rl_config(["--ppo_policy1"])
    assert cfg.rl.use_policy1 and cfg.rl.ppo_policy1
    assert tcli.main(["rl", "--ppo_policy1", "--iterations", "1", "--batch_size", "2",
                      "--vid_length", "5", "--time_steps", "4", "--n_updates_per_ppo", "1",
                      "--run_dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PPO/actor1_loss=" in out and "PPO/critic1_loss=" in out


def test_pretrain_imitate_and_pipeline_on_the_cpu(monkeypatch, tmp_path, capsys):
    """`pretrain` and `imitate` train and checkpoint on a tiny config;
    `pipeline` passes every flag to `pipeline.run` on its default config."""
    c = _tiny_config(batch_size=2)
    tiny = from_dict(dataclasses.asdict(c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), pn2_num_frames=20,
                                  canvas_size=160, canvas_tiles_per_row=5))))
    monkeypatch.setattr(tcli, "Config", lambda: tiny)
    run_dir = tmp_path / "runs"
    assert tcli.main(["pretrain", "--steps", "2", "--batch_size", "2", "--run_dir",
                      str(run_dir), "--device", "cpu"]) == 0
    assert "[pretrain 1] Loss/mse_loss=" in capsys.readouterr().out
    (ck,) = glob.glob(str(run_dir / "local_net_pretrain" / "*" / "checkpoints"))
    assert os.listdir(ck) == ["0"]
    assert tcli.main(["imitate", "--steps", "2", "--run_dir", str(run_dir),
                      "--device", "cpu"]) == 0
    assert "[imitate 1] Loss/expert_loss=" in capsys.readouterr().out
    assert glob.glob(str(run_dir / "warm_start_pn2" / "*" / "checkpoints" / "0"))

    from rovr_torch.train import pipeline

    seen = []
    monkeypatch.setattr(pipeline, "run", lambda cfg, **kw: seen.append((cfg, kw)) or {})
    assert tcli.main(["pipeline", "--pretrain_steps", "3", "--texture", "0.5",
                      "--eval_ci_clips", "0", "--out", "rec.json", "--device", "cpu"]) == 0
    (cfg, kw), = seen
    assert cfg.data.synthetic_scheme == "raster" and cfg.rl.context_policy == "attention"
    assert kw["pretrain_steps"] == 3 and kw["texture"] == 0.5 and kw["eval_ci_clips"] == 0
    assert kw["out_path"] == "rec.json" and kw["device"] == "cpu"
