"""Device ms per unit of the work the program launches under its span
`rovr/raft/encode` (each RAFT call's feature encoder over both frames and
its context encoder), summed over the unit's RAFT calls. None where the
program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/raft/encode")
