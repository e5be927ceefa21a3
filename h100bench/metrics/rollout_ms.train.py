"""Device ms per unit of the work the program launches under its span
`rovr/rollout` (the episode: its init, the T rollout steps, the
rewards-to-go and the trajectory). None where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/rollout")
