"""End to end: seconds from the start of the process to the first timed
solve: imports, the CUDA context, the kernels' build or load, the problem's
construction, the starts and the warm-up solve."""


def read(obs):
    return obs.setup_s
