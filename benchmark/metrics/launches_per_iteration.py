"""Host dispatch: kernels the device ran in the traced window per solver
loop iteration run there."""


def read(obs):
    t = obs.trace
    if t is None or not t.iterations_run or not t.launches:
        return None
    return t.launches / t.iterations_run
