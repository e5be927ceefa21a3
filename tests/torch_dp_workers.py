"""Per-rank work of tests/test_torch_data_parallel.py, run in processes that
`rovr_torch.parallel.launch.spawn` starts (gloo on the CPU). It imports no
JAX, so each process starts in seconds. Every rank writes what it saw to
<out>/rank<r>.pt; the test process compares."""

import os

import numpy as np
import torch

from rovr_torch import infer
from rovr_torch.config import MeshConfig
from rovr_torch.data.dataset import DevicePrefetcher
from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import local_rows, make_mesh, replicate
from rovr_torch.train import rl
from rovr_torch.utils.checkpoint import CheckpointManager


class Items:
    """Items of two arrays whose axis 0 (6 rows) the mesh splits."""

    def __len__(self):
        return 5

    def __getitem__(self, i):
        return (np.arange(6 * 4, dtype=np.float32).reshape(6, 4) + 100 * i,
                np.full((6, 2), i, np.int64))


def _refusals(mesh) -> dict:
    """The (data, model) grid of model_parallel = the world, and the grids
    that do not cover the world (refused)."""
    grid = make_mesh(MeshConfig(data_parallel=0, model_parallel=mesh.size))
    out = {"model_parallel": dict(shape=grid.shape, index=(grid.rank, grid.model_rank),
                                  ring=collectives.ppermute_ring(
                                      torch.tensor([float(grid.model_rank)]), grid,
                                      "model"))}
    for name, cfg in (("grid", MeshConfig(data_parallel=mesh.size, model_parallel=2)),
                      ("data_parallel", MeshConfig(data_parallel=mesh.size + 1))):
        try:
            make_mesh(cfg)
            out[name] = None
        except ValueError as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _collectives(mesh) -> dict:
    r = mesh.rank
    x = torch.arange(4.0) + 10 * r
    g = torch.full((2,), float(r + 1), requires_grad=True)
    (collectives.pmean(g, mesh) * torch.tensor([1.0, 2.0])).sum().backward()
    return dict(
        psum=collectives.psum(x, mesh), pmean=collectives.pmean(x, mesh),
        all_gather=collectives.all_gather(x[None], mesh, axis=0),
        stacked=collectives.all_gather(x, mesh, tiled=False),
        reduce_scatter=collectives.reduce_scatter(torch.arange(4.0 * mesh.size) * (r + 1),
                                                  mesh),
        ring=collectives.ppermute_ring(x, mesh), axis_index=collectives.axis_index(mesh),
        pmean_grad=g.grad, wrong_device=_wrong_device(mesh),
        refusals=_refusals(mesh))


def _wrong_device(mesh):
    try:
        collectives.psum(torch.zeros(1, device="meta"), mesh)
    except ValueError as e:
        return str(e)
    return None


def _train(mesh, case) -> dict:
    cfg = case["cfg"]
    mods = rl.make_modules(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    state = replicate(mesh, rl.init_state(cfg, mods, seed=0))
    step = rl.make_sharded_train_step(mesh, mods, cfg)
    before = dict(collectives.CALLS)
    new, metrics, recon = step(state, case["video"], case["org"], gumbel=case["gumbel"],
                               masks=case["masks"], gumbel1=case.get("gumbel1"))
    out = dict(metrics={k: float(v) for k, v in metrics.items()}, recon=recon,
               state=new, rows=local_rows(mesh, case["video"].shape[0]),
               calls={k: v - before.get(k, 0) for k, v in collectives.CALLS.items()})
    if case.get("serve"):
        u8 = (case["video"] * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        out["serve"] = list(infer.reconstruct_clips(cfg, state, mods, [u8], mesh=mesh))
    if case.get("checkpoint"):
        mgr = CheckpointManager(case["checkpoint"], mesh=mesh)
        mgr.save(0, new, force=True)
        mgr.wait()
        out["checkpoint_files"] = sorted(os.listdir(case["checkpoint"]))
        fresh = rl.init_state(cfg, mods, seed=1)
        out["restored"] = mgr.restore(template=fresh)
        mgr.close()
    return out


def _moe_unbound(mesh, cfg):
    """The MoE step with modules not built on the mesh: refused (their
    routing would be this shard's, not the global batch's)."""
    mods = rl.make_modules(cfg, dtype=torch.float32, device="cpu")
    try:
        rl.make_sharded_train_step(mesh, mods, cfg)
    except ValueError as e:
        return str(e)
    return None


def run_all(mesh, inputs_path: str, out_dir: str) -> None:
    inputs = torch.load(inputs_path, weights_only=False)
    res = {"collectives": _collectives(mesh), "calls_before": dict(collectives.CALLS)}
    for name, case in inputs["train"].items():
        res[name] = _train(mesh, case)
    res["calls"] = dict(collectives.CALLS)
    pre = DevicePrefetcher(Items(), num_workers=2, sharding=mesh)
    res["prefetch"] = [tuple(t.clone() for t in item) for item in pre]
    pre.close()
    res["moe_unbound"] = _moe_unbound(mesh, inputs["train"]["moe"]["cfg"])
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
