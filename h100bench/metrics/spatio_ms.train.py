"""Device ms per unit of the work the program launches under its span
`rovr/rollout/spatio` (the spatio signal at the episode's end: RAFT over
the reconstruction, the original and the corrupted clip, their resizes
and flow magnitudes, and the reward). None where the program has no such
span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/rollout/spatio")
