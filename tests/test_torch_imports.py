"""Import hygiene of the PyTorch port: `rovr_torch` must import neither JAX
(nor flax/optax) nor anything of `rovr_tpu`, and its entry points run on
CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_WALK = """
import importlib, pkgutil, sys
import rovr_torch
names = [m.name for m in pkgutil.walk_packages(rovr_torch.__path__, "rovr_torch.")]
for want in ("models.action_lstm", "models.moe", "parallel.mesh", "parallel.collectives",
             "parallel.launch", "parallel.tp", "parallel.pp", "parallel.ring_attention",
             "parallel.dryrun"):
    assert "rovr_torch." + want in names, names
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "rovr_tpu"))
print(len(names), bad)
"""


def test_every_module_imports_without_jax_or_rovr_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _WALK], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 46  # every module of the package was walked, __main__ too
    assert bad == "[]", f"rovr_torch pulled in {bad}"


def test_no_source_line_imports_jax_or_rovr_tpu():
    for path in (ROOT / "rovr_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "flax", "optax", "rovr_tpu"), f"{path}: {s}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_cuda(no_cuda):
    from rovr_torch import infer
    from rovr_torch.config import Config
    from rovr_torch.train import rl

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl.make_modules(Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.run(Config(), num_clips=1)


def test_training_and_eval_entry_points_refuse_without_cuda(no_cuda, tmp_path):
    """rl.run, evaluate.run/run_ci and the CLI (no --device) refuse too."""
    import dataclasses

    from rovr_torch import cli
    from rovr_torch.config import Config
    from rovr_torch.train import evaluate, rl

    c = Config()
    cfg = c.replace(run=dataclasses.replace(c.run, run_dir=str(tmp_path)))
    for call in (lambda: rl.run(cfg, iterations=1),
                 lambda: evaluate.run(cfg, num_videos=1),
                 lambda: evaluate.run_ci(cfg, num_videos=1),
                 lambda: cli.main(["reconstruct", "--num_clips", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    import dataclasses

    from rovr_torch.config import Config
    from rovr_torch.train import rl

    c = Config()
    cfg = c.replace(model=dataclasses.replace(
        c.model, backbone="tiny", lpips_stages=((8, 1),),
        local_net_channels=(8, 16, 32, 64), pn2_fc_dims=(16,)))
    mods = rl.make_modules(cfg, device="cpu")
    assert all(p.device.type == "cpu" for m in mods if m is not None
               for p in m.parameters())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a GPU chip_smoke.py exits non-zero and prints no result, in
    the checkout and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
