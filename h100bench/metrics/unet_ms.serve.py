"""Device ms per unit of the work the program launches under its span
`rovr/rollout/unet` (the UNet call at each rollout step, summed over the
batch). None where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/rollout/unet")
