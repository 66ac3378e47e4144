"""Device: the most device memory that tensors held during the measured
window (torch.cuda.max_memory_allocated after a reset at its start)."""


def read(obs):
    return obs.peak_bytes / 2 ** 30 if obs.peak_bytes else None
