"""URDF front end: parse a URDF into the port's kinematic chains.

Counterpart of ``ocs2_tpu/models/urdf.py`` (the reference's URDF front door,
``getPinocchioInterfaceFromUrdfFile``, used by every example interface with a
base frame, an end-effector frame and removed joints).  Serial chains are
extracted from the URDF link / joint tree (base frame -> target frame), every
fixed joint folded into the next movable joint's origin, giving a
``kinematics.Chain``; a branching tree gives one chain per end effector.

numpy and ``xml.etree`` only.  The bundled URDFs are the port's own copies
in ``models/assets/``.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kinematics import Chain, Joint, rpy_matrix

_MOVABLE = ("revolute", "continuous", "prismatic")

# Kinematics-only URDFs (published manufacturer parameters) of the arms the
# reference configures for its mobile manipulator.
_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


def asset_path(name: str) -> str:
    """Path of a bundled URDF, e.g. 'franka_panda.urdf', 'ur5.urdf'."""
    p = os.path.join(_ASSET_DIR, name)
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


@dataclasses.dataclass(frozen=True)
class UrdfJoint:
    name: str
    kind: str  # revolute | continuous | prismatic | fixed (others -> fixed)
    parent: str
    child: str
    xyz: Tuple[float, float, float]
    rpy: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    lower: float
    upper: float
    velocity: float
    effort: float


@dataclasses.dataclass(frozen=True)
class UrdfModel:
    """Parsed URDF: joints, link names, root link."""

    name: str
    joints: Tuple[UrdfJoint, ...]
    root_link: str
    links: Tuple[str, ...]

    def joint_by_child(self) -> Dict[str, UrdfJoint]:
        return {j.child: j for j in self.joints}

    def chain_links(self, base_link: str, ee_link: str) -> List[str]:
        """Link path base_link -> ee_link (walking parent pointers up)."""
        by_child = self.joint_by_child()
        path = [ee_link]
        cur = ee_link
        while cur != base_link:
            if cur not in by_child:
                raise ValueError(
                    f"no path from '{base_link}' to '{ee_link}' "
                    f"(reached root at '{cur}')"
                )
            cur = by_child[cur].parent
            path.append(cur)
        return list(reversed(path))


def _floats(s: Optional[str], default=(0.0, 0.0, 0.0)):
    if s is None:
        return tuple(default)
    return tuple(float(v) for v in s.split())


def _limit(limit, key: str, default: str) -> float:
    return float(limit.get(key, default)) if limit is not None else float(default)


def parse_urdf(source: str) -> UrdfModel:
    """Parse URDF XML from a file path or a raw XML string."""
    text = source
    if not source.lstrip().startswith("<"):
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"not a URDF (root tag {root.tag!r})")
    joints: List[UrdfJoint] = []
    links = [ln.get("name") for ln in root.findall("link")]
    for j in root.findall("joint"):
        kind = j.get("type", "fixed")
        if kind not in _MOVABLE:
            kind = "fixed"
        origin = j.find("origin")
        axis_el = j.find("axis")
        limit = j.find("limit")
        lower, upper = _limit(limit, "lower", "-inf"), _limit(limit, "upper", "inf")
        if j.get("type") == "continuous":
            lower, upper = -np.inf, np.inf
        joints.append(
            UrdfJoint(
                name=j.get("name"),
                kind=kind,
                parent=j.find("parent").get("link"),
                child=j.find("child").get("link"),
                xyz=_floats(origin.get("xyz") if origin is not None else None),
                rpy=_floats(origin.get("rpy") if origin is not None else None),
                axis=_floats(
                    axis_el.get("xyz") if axis_el is not None else None, (1.0, 0.0, 0.0)
                ),
                lower=lower,
                upper=upper,
                velocity=_limit(limit, "velocity", "inf"),
                effort=_limit(limit, "effort", "inf"),
            )
        )
    children = {j.child for j in joints}
    roots = [ln for ln in links if ln not in children]
    if not roots:
        raise ValueError("URDF has no root link")
    return UrdfModel(
        name=root.get("name", ""),
        joints=tuple(joints),
        root_link=roots[0],
        links=tuple(links),
    )


@dataclasses.dataclass(frozen=True)
class LoadedChain:
    """A chain plus the metadata robot interfaces read."""

    chain: Chain
    joint_names: Tuple[str, ...]
    lower: np.ndarray  # [dof]
    upper: np.ndarray
    velocity: np.ndarray


def chain_from_urdf(
    source,
    base_link: str,
    ee_link: str,
    remove_joints: Sequence[str] = (),
) -> LoadedChain:
    """Extract the serial chain base_link -> ee_link.

    ``remove_joints`` are held fixed at zero (the reference's removeJoints).
    Every fixed transform is folded into the following movable joint's origin
    by Trans(p1) Rot(R1) Trans(p2) Rot(R2) = Trans(p1 + R1 p2) Rot(R1 R2); a
    trailing fixed tail becomes the chain's ee offset and rotation."""
    model = source if isinstance(source, UrdfModel) else parse_urdf(source)
    by_child = model.joint_by_child()
    path = model.chain_links(base_link, ee_link)
    removed = set(remove_joints)

    joints: List[Joint] = []
    names: List[str] = []
    lows: List[float] = []
    ups: List[float] = []
    vels: List[float] = []
    # Accumulated fixed transform (p, R) since the last movable joint.
    p_acc = np.zeros(3)
    r_acc = np.eye(3)
    for child in path[1:]:
        uj = by_child[child]
        p_acc = p_acc + r_acc @ np.asarray(uj.xyz, np.float64)
        r_acc = r_acc @ rpy_matrix(uj.rpy)
        if uj.kind == "fixed" or uj.name in removed:
            continue
        is_ident = np.allclose(r_acc, np.eye(3), atol=1e-12)
        joints.append(
            Joint(
                offset=tuple(p_acc.tolist()),
                axis=tuple(float(v) for v in uj.axis),
                kind="revolute" if uj.kind in ("revolute", "continuous") else "prismatic",
                origin_rot=None if is_ident else tuple(r_acc.ravel().tolist()),
                name=uj.name,
            )
        )
        names.append(uj.name)
        lows.append(uj.lower)
        ups.append(uj.upper)
        vels.append(uj.velocity)
        p_acc = np.zeros(3)
        r_acc = np.eye(3)

    ee_ident = np.allclose(r_acc, np.eye(3), atol=1e-12)
    chain = Chain(
        joints=tuple(joints),
        ee_offset=tuple(p_acc.tolist()),
        ee_rot=None if ee_ident else tuple(r_acc.ravel().tolist()),
    )
    return LoadedChain(
        chain=chain,
        joint_names=tuple(names),
        lower=np.asarray(lows, np.float64),
        upper=np.asarray(ups, np.float64),
        velocity=np.asarray(vels, np.float64),
    )
