"""K1's least time (work.py: conv3, conv4, conv5 of each UNet call) over
the device time of the kernels named here, in %."""
from readers import roofline

KERNELS = ("conv3x3_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, "k1_bound_ms")
