"""The least time of the step's attention calls (work.py: K2 at the
rollout's and PPO's shapes, K3 and K4 at PPO's) over the device time of
the kernels named here, in %."""
from readers import roofline

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(ctx):
    return roofline(ctx, KERNELS, "attn_bound_ms")
