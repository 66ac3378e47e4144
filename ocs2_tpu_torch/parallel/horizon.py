"""Horizon (time-axis) sharding: PIPG with the stage axis split over a mesh.

Counterpart of ``ocs2_tpu/parallel/horizon.py``.  PIPG's per-stage updates
couple only through the one-step neighbour terms of G z and G' eta, so the
stage axis can be split into D shards of nb stages that exchange a halo
every iteration.  Shard d owns stages k in [d nb, (d + 1) nb) and the state
nodes with the same indices; the terminal node dx_N is replicated.

* G z: the last stage of a shard needs dx_{k+1}, the right neighbour's
  first node (the last shard takes dx_N);
* G' eta: the -eta_k of a shard's last stage lands on the right neighbour's
  first node (shard 0 takes none: node 0 is pinned);
* the gradient of dx_N is -eta_{N-1}, which only the last shard holds (the
  JAX package's ``psum``), and the residual is a max over shards (``pmax``).

The shards on one device are one tensor with the shards as a dim
(``[B, S, nb, ...]``, ``mesh.device_groups``): a halo between two of them is
a shift along that dim, and only a halo between devices is a copy.  So on
one device the sharded iteration costs the launches of ``ops/pipg.pipg_solve``
and computes the same numbers up to rounding.  The step sizes come from the
global power iterations, as in the JAX package.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..ops.pipg import PipgSettings, estimate_cost_eigs, estimate_sigma
from ..ops.riccati import LqrCoeffs
from .mesh import Mesh, device_groups

Tensor = torch.Tensor


class ShardedPipgSolution(NamedTuple):
    dxs: Tensor  # [B, N+1, nx] (gathered)
    dus: Tensor  # [B, N, nu]
    primal_residual: Tensor  # [B]


class _Group(NamedTuple):
    """The stage data of the consecutive shards on one device: leaves
    [B, S, nb, ...]; the terminal Qf [B, nx, nx], qf [B, nx] replicated."""

    device: torch.device
    pin: Tensor  # [1, S, nb, 1] True at node 0 (the first group only)
    A: Tensor
    B: Tensor
    b: Tensor
    Qxx: Tensor
    qx: Tensor
    Quu: Tensor
    qu: Tensor
    Qux: Tensor
    Qf: Tensor
    qf: Tensor


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(m: Tensor, v: Tensor) -> Tensor:
    return (m.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def _next_firsts(zx: List[Tensor], zxn: List[Tensor]) -> List[Tensor]:
    """For every shard, the first node of its right neighbour [B, S, nx]; the
    last shard's is dx_N.  Between devices, one copy of one node."""
    out = []
    for g, z in enumerate(zx):
        edge = zxn[g] if g == len(zx) - 1 else zx[g + 1][:, 0, 0].to(z.device)
        out.append(torch.cat([z[:, 1:, 0], edge[:, None]], dim=1))
    return out


def _prev_lasts(eta: List[Tensor]) -> List[Tensor]:
    """For every shard, the last dual of its left neighbour [B, S, nx]; the
    first shard's is zero."""
    out = []
    for g, e in enumerate(eta):
        edge = torch.zeros_like(e[:, 0, -1]) if g == 0 else eta[g - 1][:, -1, -1].to(e.device)
        out.append(torch.cat([edge[:, None], e[:, :-1, -1]], dim=1))
    return out


def _g_matvec(grp: _Group, zx: Tensor, zu: Tensor, nxt: Tensor) -> Tensor:
    """Dynamics rows A zx + B zu - zx_next of the group's stages."""
    zx_next = torch.cat([zx[:, :, 1:], nxt[:, :, None]], dim=2)
    return _mv(grp.A, zx) + _mv(grp.B, zu) - zx_next


def pipg_solve_horizon_sharded(
    coeffs: LqrCoeffs,
    mesh: Mesh,
    settings: PipgSettings = PipgSettings(),
    axis: str = "time",
) -> ShardedPipgSolution:
    """Horizon-sharded PIPG of a batch of QPs: leaves [B, N, ...] with N
    divisible by the mesh's ``axis`` size.  The iteration is
    ``ops/pipg.pipg_solve``'s (no input box); the result is gathered on the
    coefficients' device."""
    batch, n, nx = coeffs.b.shape
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"horizon {n} not divisible by mesh axis {axis!r} of size {d}")
    nb = n // d
    home = coeffs.b.device

    # Global step sizes, as in the single-device solve.
    mu, lam = estimate_cost_eigs(coeffs, settings.power_iterations)
    sigma = settings.sigma_safety * torch.abs(estimate_sigma(coeffs, settings.power_iterations))
    omega = torch.clamp(lam, min=1e-6)
    alpha = 2.0 / (torch.sqrt(mu * mu + 4.0 * omega * sigma) + mu)
    beta = omega * alpha
    rho = settings.relaxation

    groups: List[_Group] = []
    for dev, first, count in device_groups(mesh):
        rows = slice(first * nb, (first + count) * nb)

        def local(leaf, dev=dev, rows=rows, count=count):
            return leaf[:, rows].reshape((batch, count, nb) + leaf.shape[2:]).to(dev)

        pin = torch.zeros((1, count, nb, 1), dtype=torch.bool, device=dev)
        if first == 0:
            pin[0, 0, 0, 0] = True
        groups.append(_Group(
            dev, pin, *(local(getattr(coeffs, f)) for f in LqrCoeffs._fields[:8]),
            coeffs.Qf.to(dev), coeffs.qf.to(dev)))

    def per(v, dev, dims):
        return v.to(dev).reshape((batch,) + (1,) * dims)

    a_s = [per(alpha, g.device, 3) for g in groups]  # against [B, S, nb, m]
    a_n = [per(alpha, g.device, 1) for g in groups]  # against [B, nx]
    b_s = [per(beta, g.device, 3) for g in groups]
    zx = [torch.zeros_like(g.b) for g in groups]
    zu = [torch.zeros_like(g.qu) for g in groups]
    w = [torch.zeros_like(g.b) for g in groups]
    zxn = [torch.zeros_like(g.qf) for g in groups]

    for _ in range(settings.num_iterations):
        # v = w + beta (G z + b); z+ = z - alpha (Q z + q + G' v) with dx_0
        # pinned; w+ = w + beta (G z+ + b); then over-relaxation.
        nxt = _next_firsts(zx, zxn)
        v = [w[i] + b_s[i] * (_g_matvec(g, zx[i], zu[i], nxt[i]) + g.b)
             for i, g in enumerate(groups)]
        prv = _prev_lasts(v)
        last = -v[-1][:, -1, -1]  # the gradient of dx_N from G' v
        zx_n, zu_n, zxn_n = [], [], []
        for i, g in enumerate(groups):
            cgx = _mv(g.Qxx, zx[i]) + _mtv(g.Qux, zu[i])  # Q z
            cgu = _mv(g.Quu, zu[i]) + _mv(g.Qux, zx[i])
            ggx = _mtv(g.A, v[i]) - torch.cat([prv[i][:, :, None], v[i][:, :, :-1]], dim=2)  # G' v
            x_new = zx[i] - a_s[i] * (cgx + g.qx + ggx)
            zx_n.append(torch.where(g.pin, torch.zeros_like(x_new), x_new))
            zu_n.append(zu[i] - a_s[i] * (cgu + g.qu + _mtv(g.B, v[i])))
            zxn_n.append(zxn[i] - a_n[i] * (_mv(g.Qf, zxn[i]) + g.qf + last.to(g.device)))
        nxt = _next_firsts(zx_n, zxn_n)
        w = [w[i] + b_s[i] * (_g_matvec(g, zx_n[i], zu_n[i], nxt[i]) + g.b)
             for i, g in enumerate(groups)]
        zx = [(1.0 - rho) * zx[i] + rho * zx_n[i] for i in range(len(groups))]
        zu = [(1.0 - rho) * zu[i] + rho * zu_n[i] for i in range(len(groups))]
        zxn = [(1.0 - rho) * zxn[i] + rho * zxn_n[i] for i in range(len(groups))]

    nxt = _next_firsts(zx, zxn)
    res = torch.stack([
        torch.amax(torch.abs(_g_matvec(g, zx[i], zu[i], nxt[i]) + g.b), dim=(1, 2, 3)).to(home)
        for i, g in enumerate(groups)
    ]).amax(dim=0)
    dxs = torch.cat([z.reshape(batch, -1, nx).to(home) for z in zx] + [zxn[-1].to(home)[:, None]],
                    dim=1)
    dus = torch.cat([u.reshape(batch, -1, u.shape[-1]).to(home) for u in zu], dim=1)
    return ShardedPipgSolution(dxs=dxs, dus=dus, primal_residual=res)
