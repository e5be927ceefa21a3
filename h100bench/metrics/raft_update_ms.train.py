"""Device ms per unit of the work the program launches under its span
`rovr/raft/update` (each RAFT call's refinement iterations: the lookups,
the motion encoder, the GRU and the flow head), summed over the unit's
RAFT calls. None where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/raft/update")
