"""1 - device busy (the union of its kernels, copies and sets) in the
profiled units over the wall time of as many units unprofiled, in %."""
from readers import idle_share


def read(ctx):
    return idle_share(ctx)
