"""Device ms per unit of the work the program launches under its span
`rovr/rollout/reencode` (the frame write, the ResNet re-encode and the
feature-table update at each rollout step, summed over the step). None
where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/rollout/reencode")
