"""Policy export for deployment.

Counterpart of ``ocs2_tpu/learning/export.py`` (the reference deploys its
policy through ONNX: mpcnet.py:135, MpcnetOnnxController.h:59).  The
checkpoint is a dict of plain numpy arrays in the JAX package's keys and
layout, ``params/<layer>/kernel`` as [in, out] and ``params/<layer>/bias``,
so a checkpoint of either package loads into the other
(``convert.policy_from_numpy`` fills a module from one); ``numpy_policy``
is the JAX package's dependency-free numpy forward pass, copied as it is.
It has no branch for ``MixtureOfLinearExpertsPolicy``: that family's keys
(``gate``, ``expert{e}``) fall through to the MLP branch and fail its
assert, in both packages.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
from torch import nn


def export_params(module: nn.Module) -> Dict[str, np.ndarray]:
    """Flatten a policy module into {"params/<layer>/kernel" [in, out],
    "params/<layer>/bias"}: the keys and layout of the JAX package's export
    of the same architecture (np.savez-able)."""
    out = {}
    for name, layer in module.named_children():
        if isinstance(layer, nn.Linear):
            out[f"params/{name}/bias"] = layer.bias.detach().cpu().numpy().copy()
            out[f"params/{name}/kernel"] = layer.weight.detach().cpu().numpy().T.copy()
    return out


def save_checkpoint(path: str, module: nn.Module) -> None:
    np.savez(path, **export_params(module))


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _dense(weights: Dict[str, np.ndarray], name: str, x: np.ndarray):
    return x @ weights[f"params/{name}/kernel"] + weights[f"params/{name}/bias"]


def numpy_policy(weights: Dict[str, np.ndarray]) -> Callable:
    """Reconstruct a pure-numpy forward obs -> action from an exported
    checkpoint.  Detects the policy family from the parameter names
    (linear / hidden_i+out MLP / gate+experts mixture)."""
    names = set(weights)

    def layers_with(prefix):
        idx = 0
        found = []
        while f"params/{prefix}{idx}/kernel" in names or (
            f"params/{prefix}_{idx}/kernel" in names
        ):
            key = (
                f"{prefix}{idx}"
                if f"params/{prefix}{idx}/kernel" in names
                else f"{prefix}_{idx}"
            )
            found.append(key)
            idx += 1
        return found

    if "params/linear/kernel" in names:

        def forward(obs):
            return _dense(weights, "linear", np.asarray(obs))

        return forward

    if "params/gate_out/kernel" in names:
        num_experts = weights["params/gate_out/bias"].shape[0]
        expert_layers = {
            e: layers_with(f"expert{e}_hidden") for e in range(num_experts)
        }

        def forward(obs):
            obs = np.asarray(obs)
            g = np.tanh(_dense(weights, "gate_hidden", obs))
            logits = _dense(weights, "gate_out", g)
            logits = logits - logits.max(axis=-1, keepdims=True)
            gates = np.exp(logits)
            gates = gates / gates.sum(axis=-1, keepdims=True)
            outs = []
            for e in range(num_experts):
                h = obs
                for layer in expert_layers[e]:
                    h = np.tanh(_dense(weights, layer, h))
                outs.append(_dense(weights, f"expert{e}_out", h))
            stacked = np.stack(outs, axis=-2)  # [..., E, u]
            return np.einsum("...e,...eu->...u", gates, stacked)

        return forward

    hidden = layers_with("hidden")
    assert hidden and "params/out/kernel" in names, sorted(names)

    def forward(obs):
        h = np.asarray(obs)
        for layer in hidden:
            h = np.tanh(_dense(weights, layer, h))
        return _dense(weights, "out", h)

    return forward
