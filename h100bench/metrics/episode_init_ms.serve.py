"""Device ms per unit of the work the program launches under its profiler
range `rovr/episode_init` (the LPIPS baseline and the VideoProcessor encode)."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/episode_init")
