"""Device ms per unit of the work the program launches under its span
`rovr/rollout` (the greedy episode: its init and the T rollout steps). None
where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/rollout")
