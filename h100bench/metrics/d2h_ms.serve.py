"""Device ms per unit of the work the program launches under its span
`rovr/serve/d2h` (the quantize to uint8 and the copies of frames and
actions to the host). None where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/serve/d2h")
