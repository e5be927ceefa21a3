"""Numeric guardrails (rovr_tpu/utils/debug.py, PyTorch port): the
reference's always-on autograd anomaly detection (rovr.py:82,
`torch.autograd.set_detect_anomaly(True)`), here switched on for debug runs
only, and `checked(fn)`, which raises on the first non-finite output.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


def enable_anomaly_detection(check_nan: bool = True) -> None:
    """Autograd anomaly mode: a backward that makes NaN raises, naming the
    forward op (slow: debug runs only, as in the reference)."""
    torch.autograd.set_detect_anomaly(True, check_nan=check_nan)


def disable_anomaly_detection() -> None:
    torch.autograd.set_detect_anomaly(False)


def _leaves(tree, path: str):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def checked(fn: Callable) -> Callable:
    """`fn` that raises FloatingPointError, naming the output and its count
    of NaN/inf values, when a floating-point tensor it returns is not finite
    (each check waits for the device)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _leaves(out, "output"):
            if t.is_floating_point():
                bad = int((~torch.isfinite(t)).sum())
                if bad:
                    raise FloatingPointError(
                        f"{getattr(fn, '__name__', 'fn')}: {path} has {bad} non-finite "
                        f"value(s) of {t.numel()} (shape {tuple(t.shape)})")
        return out

    return wrapper
