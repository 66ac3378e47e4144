"""The general traffic generator of a closed-loop batch cell.

From ``--seed`` alone, on the device, in one call each: ``pool_batches``
batches of ``batch`` starts, nominal + ``start_scale`` N(0, 1) per state, one
more batch for the warm-up, and for every pool batch the rows that the
correctness check samples.  Batch i of the window is pool batch
i mod ``pool_batches``, so a seed fixes every start and every sampled row.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Starts:
    pool: torch.Tensor  # [P, B, nx]
    warmup: torch.Tensor  # [B, nx]
    sample_rows: torch.Tensor  # [P, k] row indices into each pool batch

    def batch(self, i: int) -> torch.Tensor:
        return self.pool[i % self.pool.shape[0]]

    def rows(self, i: int) -> torch.Tensor:
        return self.sample_rows[i % self.pool.shape[0]]


def draw(traffic: dict, nominal: torch.Tensor, seed: int) -> Starts:
    dev = nominal.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    pool, batch = int(traffic["pool_batches"]), int(traffic["batch"])
    nx = nominal.shape[-1]
    noise = torch.randn((pool + 1, batch, nx), generator=gen, device=dev)
    starts = nominal + float(traffic["start_scale"]) * noise
    order = torch.rand((pool, batch), generator=gen, device=dev).argsort(dim=1)
    return Starts(pool=starts[:pool], warmup=starts[pool],
                  sample_rows=order[:, :int(traffic["sample_per_batch"])])
