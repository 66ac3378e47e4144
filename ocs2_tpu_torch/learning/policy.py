"""MPC-Net policy architectures as ``torch.nn`` modules.

Counterpart of ``ocs2_tpu/learning/policy.py`` (the reference's
policy/linear.py, nonlinear.py, mixture_of_linear_experts.py,
mixture_of_nonlinear_experts.py).  The layers keep the JAX package's names
(``linear``, ``hidden_{i}``, ``out``, ``gate``, ``gate_hidden``,
``gate_out``, ``expert{e}``, ``expert{e}_hidden{i}``, ``expert{e}_out``),
so an exported checkpoint has the same keys in both packages
(``learning/export.py``), and are initialised as flax's ``Dense`` is: the
kernel from ``lecun_normal`` (a normal truncated at two standard deviations,
variance 1 / fan_in), the bias at zero.  A flax module sizes its layers at
``init`` from the observation; here the observation width ``obs_dim`` is a
constructor argument, and the default hidden widths are the JAX package's,
``(obs_dim + action_dim) // 2``.

Each policy maps an observation (by default the state, through an
``observation_fn``) to an input u, optionally through an action transform
u = A a + b (e.g. gravity compensation for the legged robot).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

Tensor = torch.Tensor

# flax's variance_scaling divides the truncated normal's standard deviation
# by this, the standard deviation of a unit normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978


def dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator],
          device="cuda") -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``nn.Dense``: kernel [in, out]
    from lecun_normal (stored transposed, as ``nn.Linear`` keeps it), bias
    zero."""
    layer = nn.Linear(in_dim, out_dim, device=device)
    std = (1.0 / in_dim) ** 0.5 / _TRUNCATED_STD
    kernel = torch.empty((in_dim, out_dim), device=device)
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        layer.weight.copy_(kernel.T)
        layer.bias.zero_()
    return layer


class LinearPolicy(nn.Module):
    """u = W o + b."""

    def __init__(self, obs_dim: int, action_dim: int, generator=None, device="cuda"):
        super().__init__()
        self.linear = dense(obs_dim, action_dim, generator, device)

    def forward(self, obs: Tensor) -> Tensor:
        return self.linear(obs)


class NonlinearPolicy(nn.Module):
    """MLP with tanh hidden activations (default: one hidden layer of
    (obs + action) // 2)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (),
                 generator=None, device="cuda"):
        super().__init__()
        widths = tuple(hidden) or ((obs_dim + action_dim) // 2,)
        self.num_hidden = len(widths)
        prev = obs_dim
        for i, width in enumerate(widths):
            self.add_module(f"hidden_{i}", dense(prev, width, generator, device))
            prev = width
        self.out = dense(prev, action_dim, generator, device)

    def forward(self, obs: Tensor) -> Tensor:
        h = obs
        for i in range(self.num_hidden):
            h = torch.tanh(getattr(self, f"hidden_{i}")(h))
        return self.out(h)


class MixtureOfNonlinearExpertsPolicy(nn.Module):
    """Gated mixture of nonlinear experts: u = sum_e p_e(o) u_e(o) with a
    softmax gating network; ``apply_with_gates`` also returns the gate
    probabilities (for the cross-entropy gating loss)."""

    def __init__(self, obs_dim: int, action_dim: int, num_experts: int,
                 expert_hidden: Sequence[int] = (), generator=None, device="cuda"):
        super().__init__()
        self.num_experts = num_experts
        self.gate_hidden = dense(obs_dim, (obs_dim + num_experts) // 2, generator, device)
        self.gate_out = dense((obs_dim + num_experts) // 2, num_experts, generator, device)
        widths = tuple(expert_hidden) or ((obs_dim + action_dim) // 2,)
        self.num_hidden = len(widths)
        for e in range(num_experts):
            prev = obs_dim
            for i, width in enumerate(widths):
                self.add_module(f"expert{e}_hidden{i}", dense(prev, width, generator, device))
                prev = width
            self.add_module(f"expert{e}_out", dense(prev, action_dim, generator, device))

    def forward(self, obs: Tensor) -> Tensor:
        return self.apply_with_gates(obs)[0]

    def apply_with_gates(self, obs: Tensor):
        gates = torch.softmax(self.gate_out(torch.tanh(self.gate_hidden(obs))), dim=-1)
        experts = []
        for e in range(self.num_experts):
            h = obs
            for i in range(self.num_hidden):
                h = torch.tanh(getattr(self, f"expert{e}_hidden{i}")(h))
            experts.append(getattr(self, f"expert{e}_out")(h))
        u = torch.einsum("...e,...eu->...u", gates, torch.stack(experts, dim=-2))
        return u, gates


class MixtureOfLinearExpertsPolicy(nn.Module):
    """Gated mixture of linear experts: u = sum_e p_e(o) (W_e o + b_e) with
    a single-layer softmax gating network."""

    def __init__(self, obs_dim: int, action_dim: int, num_experts: int, generator=None,
                 device="cuda"):
        super().__init__()
        self.num_experts = num_experts
        self.gate = dense(obs_dim, num_experts, generator, device)
        for e in range(num_experts):
            self.add_module(f"expert{e}", dense(obs_dim, action_dim, generator, device))

    def forward(self, obs: Tensor) -> Tensor:
        return self.apply_with_gates(obs)[0]

    def apply_with_gates(self, obs: Tensor):
        gates = torch.softmax(self.gate(obs), dim=-1)
        experts = torch.stack(
            [getattr(self, f"expert{e}")(obs) for e in range(self.num_experts)], dim=-2)
        return torch.einsum("...e,...eu->...u", gates, experts), gates


def default_observation(t: Tensor, x: Tensor) -> Tensor:
    """Default observation features: the state itself."""
    del t
    return x


def make_policy_fn(
    module: nn.Module,
    observation_fn: Callable[[Tensor, Tensor], Tensor] = default_observation,
    action_transform: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
):
    """Bind a module into a (params, t, x) -> u policy function: ``params``
    is a module of the same architecture (its own weights) or a
    ``{name: tensor}`` dict of ``module``'s parameters (applied by
    ``torch.func.functional_call``, as flax applies a params tree);
    ``action_transform(t, x, a)`` maps the raw network action to the input."""

    def policy(params, t, x):
        obs = observation_fn(t, x)
        if isinstance(params, nn.Module):
            a = params(obs)
        else:
            a = torch.func.functional_call(module, params, (obs,))
        if action_transform is not None:
            return action_transform(t, x, a)
        return a

    return policy
