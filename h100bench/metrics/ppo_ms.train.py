"""Device ms per unit of the work the program launches under its span
`rovr/ppo_update` from the thread that runs it: the advantage, the PPO
epochs' forward passes and Adam; the backward passes, which autograd
launches from its own device thread, are not counted. None where the
program has no such span."""
from readers import range_ms


def read(ctx):
    return range_ms(ctx, "rovr/ppo_update")
