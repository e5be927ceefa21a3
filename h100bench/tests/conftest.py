"""Shared set-up of the benchmark's own tests: the import path (the harness's
modules import each other by their plain names, as run.py runs them) and a
tiny cell of either configuration and either mix, built the way drive.py's
`load_cell` builds a real one."""

import dataclasses
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import torch  # noqa: E402

import traffic  # noqa: E402
import work  # noqa: E402
from rovr_torch.config import Config, config_rl_scaled  # noqa: E402

TINY = dict(backbone="tiny", lpips_stages=((8, 1), (16, 1)), local_net_channels=(8, 16, 32, 64),
            pn2_fc_dims=(256, 64))
CELL = {"canvas": "default_canvas", "attention": "config5_attention"}


def tiny_config(policy: str, batch: int = 2) -> dict:
    """The configuration of `policy`'s cells at test size (the tiny trunk,
    a 2-stage LPIPS, narrow UNet and MLP, 32x32 frames, 6 or 8 frames), as
    the plain dict a configuration file holds."""
    c = config_rl_scaled(8, 1) if policy == "attention" else Config()
    s = 8 if policy == "attention" else 6
    c = c.replace(rl=dataclasses.replace(c.rl, batch_size=batch, vid_length=s, time_steps=s),
                  data=dataclasses.replace(c.data, vid_length=s, frame_size=(32, 32)),
                  model=dataclasses.replace(c.model, pn2_num_frames=s, **TINY))
    return json.loads(json.dumps(dataclasses.asdict(c)))


def control_config(policy: str, kind: str) -> dict:
    """The size the control's test runs at: the published widths at 64x64
    frames and batch 2; serving with the published frame count (20, 64),
    training with 8 frames and the small trunk in place of ResNet-50, which
    is the CPU's most costly part there. At the tiny widths fp8's rounding
    stays inside the cells' limits: it grows with the depth of the sums."""
    c = config_rl_scaled(64, 1) if policy == "attention" else Config()
    s = c.rl.vid_length if kind == "serve" else 8
    model = dict(pn2_num_frames=s) if kind == "serve" else dict(pn2_num_frames=s, backbone="tiny")
    c = c.replace(rl=dataclasses.replace(c.rl, batch_size=2, vid_length=s, time_steps=s),
                  data=dataclasses.replace(c.data, vid_length=s, frame_size=(64, 64)),
                  model=dataclasses.replace(c.model, **model))
    return json.loads(json.dumps(dataclasses.asdict(c)))


def tiny_cell(kind: str, policy: str) -> dict:
    """A cell dict as drive.load_cell gives it: the real cell's mix, metrics
    and limits, at the tiny configuration and its work."""
    name = f"{CELL[policy]}.{kind}"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    mix = traffic.load(cell["traffic"])
    mix["box"] = [8, 12]
    cfg = tiny_config(policy)
    with open(os.path.join(BENCH, "cells", f"{name}.json")) as f:
        limits = json.load(f)["limits"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    return {"cell": cell, "config": {"config": cfg}, "mix": mix,
            "work": {**work.unit(cfg, kind), "limits": limits}, "end_to_end": e2e,
            "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [])]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
