"""The whole unit's model FLOPs (work.py) over the wall time of the traced
run's unprofiled units at the H100's dense bf16 peak, in %."""
from readers import mfu


def read(ctx):
    return mfu(ctx)
