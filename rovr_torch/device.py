"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the GPU. With no CUDA device visible that raises: the
    port never falls back to the CPU on its own. Pass `device="cpu"` to run
    on the CPU (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rovr_torch runs on CUDA and no CUDA device is visible; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
