"""RAFT's least time a unit (the cell file's `raft_bound_ms`: its FLOPs at
the bf16 peak or its pyramid and lookup bytes at HBM's rate, whichever is
larger, over the three passes) over the device ms of the span
`rovr/rollout/spatio`, in %. None where the program has no such span."""
from readers import range_ms


def read(ctx):
    ms = range_ms(ctx, "rovr/rollout/spatio")
    if ms is None or "raft_bound_ms" not in ctx["work"]:
        return None
    return 100.0 * ctx["work"]["raft_bound_ms"] / ms
