"""State carried across from the JAX package, given as numpy.

What is carried between the two packages is solver state and, for MPC-Net,
policy weights.  Each function takes a record of ``ocs2_tpu`` whose leaves
were turned into numpy arrays by the caller (``rec._asdict()`` of
``jax.tree.map(np.asarray, rec)``; a mapping or an object with the same
field names) and returns the port's record as float32 tensors on ``device``.
The port never sees a JAX type.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.controllers import LinearController
from .core.reference import ModeSchedule, TargetTrajectories
from .core.types import PerformanceIndex
from .learning.mpcnet import MpcnetSample
from .models.collision import SphereModel
from .models.kinematics import Chain, Joint
from .models.legged_robot.centroidal import MassModel
from .models.legged_robot.foothold_planner import FootholdPlan
from .models.legged_robot.motions import Motion
from .models.legged_robot.segmented_planes import SegmentedPlanesTerrain
from .models.legged_robot.terrain import ElevationMap
from .models.perceptive import SignedDistanceField
from .mpc.mpc import MpcPolicy
from .oc.time_discretization import TimeGrid
from .ops.projection import Projection
from .ops.riccati import LqrCoeffs, LqrSolution
from .solvers.al import AlState
from .solvers.sqp import IterationLog, SqpSolution


def _field(rec: Any, name: str):
    return rec[name] if isinstance(rec, Mapping) else getattr(rec, name)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, dtype=np.float32), device=device)


def _record(cls, rec: Any, device):
    return cls(**{name: _f32(_field(rec, name), device) for name in cls._fields})


def lqr_coeffs_from_numpy(rec: Any, device="cuda") -> LqrCoeffs:
    return _record(LqrCoeffs, rec, device)


def lqr_solution_from_numpy(rec: Any, device="cuda") -> LqrSolution:
    return _record(LqrSolution, rec, device)


def projection_from_numpy(rec: Any, device="cuda") -> Projection:
    return _record(Projection, rec, device)


def sqp_solution_from_numpy(rec: Any, device="cuda") -> SqpSolution:
    """An ``SqpSolution`` of the JAX package (one scenario, or a vmapped
    batch) as the port's record; ``iterations`` stays int32 and
    ``converged`` bool."""
    nested = {"performance": PerformanceIndex, "al": AlState, "history": IterationLog}
    out = {}
    for name in SqpSolution._fields:
        val = _field(rec, name)
        if name in nested:
            out[name] = _record(nested[name], val, device)
        elif name == "iterations":
            out[name] = torch.as_tensor(np.array(val, dtype=np.int32), device=device)
        elif name == "converged":
            out[name] = torch.as_tensor(np.array(val, dtype=bool), device=device)
        else:
            out[name] = _f32(val, device)
    return SqpSolution(**out)


def target_trajectories_from_numpy(rec: Any, device="cuda") -> TargetTrajectories:
    return _record(TargetTrajectories, rec, device)


def al_state_from_numpy(rec: Any, device="cuda") -> AlState:
    return _record(AlState, rec, device)


def params_from_numpy(params: Mapping, device="cuda") -> dict:
    """The ``{"target": TargetTrajectories, ...}`` parameter dict of a model's
    ``make_params``: target trajectories and AL states become the port's
    records, any other array leaf (swing references, the foothold plan's
    ``fh_*`` arrays, an elevation grid) a float32 tensor."""
    out = {}
    for key, val in params.items():
        fields = set(val.keys()) if isinstance(val, Mapping) else set(
            getattr(val, "_fields", ())
        )
        if fields == set(TargetTrajectories._fields):
            out[key] = target_trajectories_from_numpy(val, device)
        elif fields == set(AlState._fields):
            out[key] = al_state_from_numpy(val, device)
        else:
            out[key] = _f32(val, device)
    return out


def time_grid_from_numpy(rec: Any, device="cuda") -> TimeGrid:
    """A TimeGrid of tensors on ``device`` (the form ``TimeGrid.device``
    gives), from the host grid's numpy leaves."""
    return TimeGrid(
        times=np.asarray(_field(rec, "times"), np.float32),
        is_jump=np.asarray(_field(rec, "is_jump"), np.float32),
        modes=np.asarray(_field(rec, "modes"), np.int32),
    ).device(device)


def linear_controller_from_numpy(rec: Any, device="cuda") -> LinearController:
    return _record(LinearController, rec, device)


def mode_schedule_from_numpy(rec: Any) -> ModeSchedule:
    """A ModeSchedule stays host data: float32 event times, int32 modes and
    event count, as numpy arrays."""
    return ModeSchedule(
        event_times=np.array(_field(rec, "event_times"), dtype=np.float32),
        mode_sequence=np.array(_field(rec, "mode_sequence"), dtype=np.int32),
        num_events=np.array(_field(rec, "num_events"), dtype=np.int32),
    )


def mpc_policy_from_numpy(rec: Any, device="cuda") -> MpcPolicy:
    """An ``MpcPolicy`` of the JAX package (controller, xs, us, node times,
    performance, mode schedule) as the port's, so it can drive the port's
    ``Mrt``."""
    return MpcPolicy(
        controller=linear_controller_from_numpy(_field(rec, "controller"), device),
        xs=_f32(_field(rec, "xs"), device),
        us=_f32(_field(rec, "us"), device),
        times=_f32(_field(rec, "times"), device),
        performance=_record(PerformanceIndex, _field(rec, "performance"), device),
        mode_schedule=mode_schedule_from_numpy(_field(rec, "mode_schedule")),
    )


def elevation_map_from_numpy(rec: Any, device="cuda") -> ElevationMap:
    return _record(ElevationMap, rec, device)


def signed_distance_field_from_numpy(rec: Any, device="cuda") -> SignedDistanceField:
    return _record(SignedDistanceField, rec, device)


def foothold_plan_from_numpy(rec: Any, device="cuda") -> FootholdPlan:
    """A FootholdPlan of the JAX package as float32 tensors on ``device``
    (``foothold_planner.plan_to_params`` takes it as it takes a host plan)."""
    return _record(FootholdPlan, rec, device)


def segmented_planes_terrain_from_numpy(rec: Any, device="cuda") -> SegmentedPlanesTerrain:
    """The segmented-planes arrays; ``num_vertices`` stays int32 and
    ``valid`` bool."""
    dtypes = {"num_vertices": np.int32, "valid": bool}
    return SegmentedPlanesTerrain(**{
        name: torch.as_tensor(np.array(_field(rec, name), dtype=dtypes.get(name, np.float32)),
                              device=device)
        for name in SegmentedPlanesTerrain._fields})


def mass_model_from_numpy(rec: Any) -> MassModel:
    """A ``MassModel`` crosses as its three floats (hip, thigh, shank)."""
    return MassModel(*(float(_field(rec, name)) for name in MassModel._fields))


def motion_from_numpy(rec: Any, device="cuda") -> Motion:
    """A ``Motion`` of the JAX package (its target's leaves and its mode
    schedule as numpy): the target on ``device``, the schedule on the host."""
    return Motion(
        target=target_trajectories_from_numpy(_field(rec, "target"), device),
        mode_schedule=mode_schedule_from_numpy(_field(rec, "mode_schedule")),
        duration=float(_field(rec, "duration")),
    )


def chain_from_numpy(rec: Any) -> Chain:
    """A kinematic chain from its joints' numbers as arrays: ``offsets``
    [J, 3], ``axes`` [J, 3] (a principal axis as its unit vector), ``kinds``
    [J] ("revolute" | "prismatic" | "fixed"), ``origin_rots`` [J, 3, 3] with
    ``has_origin_rot`` [J] (False: no origin rotation), ``names`` [J],
    ``ee_offset`` [3], ``ee_rot`` [3, 3] with ``has_ee_rot``.  The chain's
    numbers are host constants, as in ``kinematics.Chain``."""
    rows = lambda v: np.asarray(v, np.float64).reshape(-1).tolist()  # noqa: E731
    names = np.asarray(_field(rec, "names"))
    joints = tuple(
        Joint(
            offset=tuple(rows(offset)),
            axis=tuple(rows(axis)),
            kind=str(kind),
            origin_rot=tuple(rows(rot)) if bool(has_rot) else None,
            name=str(name),
        )
        for offset, axis, kind, rot, has_rot, name in zip(
            _field(rec, "offsets"), _field(rec, "axes"), _field(rec, "kinds"),
            _field(rec, "origin_rots"), _field(rec, "has_origin_rot"), names)
    )
    has_ee_rot = bool(_field(rec, "has_ee_rot"))
    return Chain(
        joints=joints,
        ee_offset=tuple(rows(_field(rec, "ee_offset"))),
        ee_rot=tuple(rows(_field(rec, "ee_rot"))) if has_ee_rot else None,
    )


def sphere_model_from_numpy(rec: Any, device="cuda") -> SphereModel:
    """A ``SphereModel`` (frame_idx, offsets, radii, pairs) on ``device``:
    indices as int64, geometry as float32."""
    return SphereModel(
        frame_idx=torch.as_tensor(np.array(_field(rec, "frame_idx"), np.int64), device=device),
        offsets=_f32(_field(rec, "offsets"), device),
        radii=_f32(_field(rec, "radii"), device),
        pairs=torch.as_tensor(np.array(_field(rec, "pairs"), np.int64).reshape(-1, 2),
                              device=device),
    )


def policy_from_numpy(weights: Mapping, module):
    """Fill a policy module (``learning/policy.py``) from the JAX package's
    exported weights (``export_params``: ``{"params/<layer>/kernel": [in,
    out], "params/<layer>/bias": [out]}``).  Every layer of the module must
    be given, with its shape; returns the module."""
    layers = dict(module.named_children())
    given = {k.split("/")[1] for k in weights if k.startswith("params/")}
    if given != set(layers):
        raise ValueError(f"layers {sorted(given)} do not match the module's {sorted(layers)}")
    with torch.no_grad():
        for name, layer in layers.items():
            kernel = torch.as_tensor(np.array(weights[f"params/{name}/kernel"], np.float32))
            bias = torch.as_tensor(np.array(weights[f"params/{name}/bias"], np.float32))
            if tuple(kernel.T.shape) != tuple(layer.weight.shape):
                raise ValueError(f"{name}: kernel {tuple(kernel.shape)} against "
                                 f"[in, out] = {tuple(layer.weight.T.shape)}")
            layer.weight.copy_(kernel.T)
            layer.bias.copy_(bias)
    return module


def mpcnet_sample_from_numpy(rec: Any, device="cuda") -> MpcnetSample:
    """MPC-Net samples of the JAX package (any leading dims) as float32
    tensors on ``device``."""
    return _record(MpcnetSample, rec, device)
