"""The measured window of a closed-loop batch cell: the next batch is solved
when the last one has returned, for ``seconds`` seconds by the host clock,
every batch whole.  The rate is taken over all the work and all the time of
the window."""
from __future__ import annotations

import dataclasses
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    batches: int
    scenarios: int
    seconds: float
    iterations_run: int  # solver loop iterations: the sum over batches of the batch's largest
    iterations_sum: int  # iterations summed over every scenario of the window
    nonfinite: int  # scenarios whose xs or us hold a value that is not finite
    samples: list  # (starts, program outputs) of the sampled rows, per batch, on the host
    batch_s: list  # host-clock seconds of each batch solve


def _batch_stats(sol) -> torch.Tensor:
    finite = (torch.isfinite(sol.xs).flatten(1).all(1) & torch.isfinite(sol.us).flatten(1).all(1))
    it = sol.iterations.to(torch.int64)
    return torch.stack([it.max(), it.sum(), (~finite).sum()])


def run(scenario, starts, seconds: float, device) -> Window:
    """Solve pool batches 0, 1, ... until ``seconds`` have passed, and keep
    the sampled rows' starts and answers."""
    stats, samples, ends = [], [], []
    sync(device)
    t0 = time.perf_counter()
    while True:
        i = len(stats)
        x0 = starts.batch(i)
        sol = scenario.solve(x0)
        stats.append(_batch_stats(sol))
        # The sampled answers wait on the host, so that the device's peak
        # is the program's own.
        rows = starts.rows(i)
        samples.append((x0[rows].cpu(),
                        {k: v.cpu() for k, v in scenario.outputs(sol, rows).items()}))
        del sol
        sync(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    elapsed = ends[-1] - t0
    s = torch.stack(stats).sum(0).tolist()
    batch = starts.pool.shape[1]
    return Window(batches=len(stats), scenarios=batch * len(stats), seconds=elapsed,
                  iterations_run=int(s[0]), iterations_sum=int(s[1]), nonfinite=int(s[2]),
                  samples=samples, batch_s=[b - a for a, b in zip([t0] + ends, ends)])
