"""Start a data-parallel job: one process per device, each in the process
group, each handed its mesh.

    spawn(fn, nprocs, device="cuda", args=(...))

runs fn(mesh, *args) in `nprocs` new processes (torch.multiprocessing's
spawn). Process r joins a group of `nprocs` at `init_method` (default: a TCP
store on a free localhost port) with rank r: NCCL on CUDA device r, or
gloo with device="cpu". `fn` and `args` must pickle (a module-level
function). A failure in any process raises here once every process has
ended.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rovr_torch.parallel.mesh import make_mesh

TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_count(device: str) -> int:
    """How many processes a job on `device` may start: the CUDA devices, or
    with device="cpu" the CPU cores."""
    if device == "cpu":
        return os.cpu_count() or 1
    return torch.cuda.device_count()


def _entry(rank, fn, nprocs, device, init_method, threads, args):
    """Process `rank`: join the group (NCCL on CUDA device `rank`, or gloo
    with device="cpu" and `threads` intra-op threads), run fn(mesh, *args),
    leave the group."""
    if device == "cpu":
        backend = "gloo"
        if threads:
            torch.set_num_threads(threads)
    else:
        backend = "nccl"
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=nprocs, rank=rank,
                            timeout=TIMEOUT)
    try:
        fn(make_mesh(), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, device: str = "cuda", args: Sequence = (),
          init_method: Optional[str] = None, threads: Optional[int] = None) -> None:
    if nprocs > device_count(device):
        raise ValueError(f"{nprocs} processes > {device_count(device)} {device} devices")
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    mp.spawn(_entry, args=(fn, nprocs, device, init_method, threads, tuple(args)),
             nprocs=nprocs, join=True)
