"""Device ms per unit of the work the program launches under its span
`rovr/serve/h2d` (the batch's copy to the card and its division by 255).
None where the program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/serve/h2d")
