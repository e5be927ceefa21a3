"""torch.cuda.max_memory_allocated() since the peak was reset before warm-up, GB."""
from readers import peak_mem_gb


def read(ctx):
    return peak_mem_gb(ctx)
