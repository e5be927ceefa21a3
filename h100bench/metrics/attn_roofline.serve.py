"""The least time of the served batch's attention calls (work.py: K2 at the
rollout's shape) over the device time of the kernels named here, in %."""
from readers import roofline

KERNELS = ("flash_fwd",)


def read(ctx):
    return roofline(ctx, KERNELS, "attn_bound_ms")
