"""Device ms per unit of the work the program launches under its span
`rovr/raft/corr` (each RAFT call's all-pairs correlation and its 4-level
pyramid), summed over the unit's RAFT calls. None where the program has no
such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/raft/corr")
