"""The port stands alone: importing every ocs2_tpu_torch module (and reading
chip_smoke.py) pulls in neither JAX nor the JAX package, starts no process
(so no compiler) and builds nothing."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ocs2_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]

_FRESH = textwrap.dedent("""
    import importlib, pkgutil, subprocess, sys, os

    def refuse(*a, **k):
        raise AssertionError(f"a process was started while importing: {a}")

    subprocess.Popen = subprocess.run = subprocess.check_output = refuse
    os.system = refuse
    import ocs2_tpu_torch
    names = ["ocs2_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ocs2_tpu_torch.__path__, "ocs2_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    roots = {m.split(".")[0] for m in sys.modules}
    bad = sorted(roots & {"jax", "jaxlib", "ocs2_tpu", "flax", "optax"})
    assert not bad, bad
    from ocs2_tpu_torch.ops import _build
    assert not _build._LOADED
    print("IMPORTED", len(names), int(_build.BUILD_DIR.exists()))
    print("MODULES", " ".join(names))
""")


@pytest.fixture(scope="module")
def fresh_import():
    existed = (PKG / "build").exists()
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH], cwd=REPO, capture_output=True, text=True, timeout=300)
    return proc, existed


def test_every_module_imports_without_jax_or_reference_package(fresh_import):
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORTED" in proc.stdout
    # core, oc, ops, solvers, models + convert: well over a dozen modules.
    assert int(proc.stdout.split()[1]) >= 20


def test_importing_builds_nothing(fresh_import):
    proc, existed = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[2]) == int(existed)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "ocs2_tpu"), (
                f"{path.name}: import of {mod}")


def test_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.core import reference
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc import problem, time_discretization
    from ocs2_tpu_torch.solvers import al, ddp

    fns = [
        ddp.solve, ballbot.make_problem, ballbot.make_params, problem.quadratic_cost,
        problem.quadratic_final_cost, problem.OptimalControlProblem.constraint_dims,
        reference.TargetTrajectories.create, reference.TargetTrajectories.constant,
        time_discretization.TimeGrid.device, al.AlState.init,
        convert.lqr_coeffs_from_numpy, convert.lqr_solution_from_numpy,
        convert.target_trajectories_from_numpy, convert.params_from_numpy,
        convert.al_state_from_numpy, convert.time_grid_from_numpy,
    ]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def _perceptive_entry_points():
    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.models.legged_robot import (
        foothold_planner,
        motion_tracking,
        segmented_planes,
        terrain,
    )

    return [
        terrain.ElevationMap.create, terrain.ElevationMap.flat, terrain.make_perceptive_problem,
        segmented_planes.decompose_planes, foothold_planner.make_segmented_perceptive_problem,
        foothold_planner.make_perceptive_params, foothold_planner.PerceptiveReferenceManager,
        motion_tracking.motion_tracking_cost, motion_tracking.make_torque_limits_soft,
        convert.elevation_map_from_numpy, convert.segmented_planes_terrain_from_numpy,
        convert.foothold_plan_from_numpy, convert.signed_distance_field_from_numpy,
    ]


@pytest.mark.parametrize("index", range(13))
def test_perceptive_entry_points_default_to_the_card(index):
    import inspect

    fn = _perceptive_entry_points()[index]
    assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("module", [
    "ops/smallmat.py", "models/perceptive.py", "models/legged_robot/terrain.py",
    "models/legged_robot/segmented_planes.py", "models/legged_robot/foothold_planner.py",
    "models/legged_robot/motion_tracking.py"])
def test_perceptive_modules_are_present_and_imported(fresh_import, module):
    """Each module of the perceptive slice exists and is among those the fresh
    interpreter imported without pulling in JAX or the JAX package."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_convert_params_roundtrip():
    import numpy as np
    import torch

    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.core.reference import TargetTrajectories
    from ocs2_tpu_torch.solvers.al import AlState

    target = dict(times=np.zeros(1), states=np.ones((1, 10)), inputs=np.zeros((1, 3)))
    al_np = dict(lmbd_eq=np.zeros((4, 1)), lmbd_state_eq=np.zeros((5, 0)),
                 lmbd_ineq=np.ones((4, 2)), lmbd_state_ineq=np.zeros((5, 0)),
                 lmbd_final_eq=np.zeros((0,)), rho=np.float64(10.0))
    p = convert.params_from_numpy(
        {"target": target, "al": al_np, "gain": np.arange(3.0)}, device="cpu")
    assert isinstance(p["target"], TargetTrajectories) and isinstance(p["al"], AlState)
    assert p["target"].states.dtype == torch.float32 and p["al"].rho.dtype == torch.float32
    assert p["gain"].tolist() == [0.0, 1.0, 2.0] and p["al"].lmbd_ineq.shape == (4, 2)


@pytest.mark.parametrize("module", [
    "solvers/ipm.py", "ops/pipg.py", "solvers/slp.py", "solvers/qp.py"])
def test_solver_slice_modules_are_present_and_imported(fresh_import, module):
    """The interior-point / PIPG / SLP slice's modules exist and are among
    those the fresh interpreter imported without JAX or the JAX package."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


def test_solver_slice_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch.mpc import mpc
    from ocs2_tpu_torch.solvers import api, ipm, slp

    for fn in (ipm.solve, slp.solve, mpc.Mpc, api.Solver):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("module", [
    "ops/riccati_ct.py", "ops/riccati_ct_cuda.py", "oc/hybrid_rollout.py",
    "solvers/hybrid_ddp.py", "solvers/switch_time.py", "ops/care.py"])
def test_ddp_family_modules_are_present_and_imported(fresh_import, module):
    """The DDP family's modules (SLQ's continuous-time sweep and its kernel's
    wrapper, the hybrid path, the CARE) exist and are among those the fresh
    interpreter imported without JAX or the JAX package."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


def test_ddp_family_entry_points_default_to_the_card_and_the_kernel_source_exists():
    import inspect

    from ocs2_tpu_torch.oc import approx, time_discretization
    from ocs2_tpu_torch.ops import _build, riccati_ct_cuda
    from ocs2_tpu_torch.solvers import hybrid_ddp

    for fn in (time_discretization.make_event_grid_traced, hybrid_ddp.solve_state_triggered):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert callable(approx.approximate_lq_ct)
    assert (_build.CSRC_DIR / riccati_ct_cuda.SOURCE).exists()


@pytest.mark.parametrize("module", [
    "models/cartpole.py", "models/kinematics.py", "models/urdf.py", "models/collision.py",
    "models/mobile_manipulator.py", "utils/recorder.py", "utils/observers.py"])
def test_model_zoo_modules_are_present_and_imported(fresh_import, module):
    """The robot model zoo's modules and the operator surface exist and are
    among those the fresh interpreter imported without JAX or the JAX
    package."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


def test_model_zoo_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.models import cartpole, collision, mobile_manipulator
    from ocs2_tpu_torch.utils import observers, recorder

    fns = [
        cartpole.make_problem, cartpole.make_params, cartpole.initial_state_down,
        mobile_manipulator.make_params, mobile_manipulator.home_state,
        mobile_manipulator.variant_home_state, mobile_manipulator.spheres,
        collision.SphereModel.create, recorder.pose_command_to_target, observers.term_slices,
        convert.sphere_model_from_numpy,
    ]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_model_zoo_assets_are_the_ports_own():
    """The bundled URDFs are read from the port's package, not the JAX
    package's."""
    from ocs2_tpu_torch.models import urdf

    for name in ("franka_panda.urdf", "ur5.urdf"):
        path = pathlib.Path(urdf.asset_path(name)).resolve()
        assert path.parent == PKG / "models" / "assets"


@pytest.mark.parametrize("module", [
    "utils/config.py", "oc/loopshaping.py", "models/legged_robot/loopshaping_mpc.py"])
def test_loopshaping_modules_are_present_and_imported(fresh_import, module):
    """Loopshaping and the config loader exist and are among the modules the
    fresh interpreter imported without JAX or the JAX package (the port keeps
    its own copy of the JAX package's framework-free ``utils/config.py``)."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


def test_loopshaping_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch.models.legged_robot import loopshaping_mpc
    from ocs2_tpu_torch.oc import loopshaping
    from ocs2_tpu_torch.utils import config

    fns = [
        loopshaping.first_order_filter, loopshaping.load_loopshaping_info,
        loopshaping_mpc.anymal_loopshaping_definition, loopshaping_mpc.make_loopshaping_problem,
        config.load_matrix,
    ]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


LEARNING_MODULES = ["learning/loss.py", "learning/memory.py", "learning/policy.py",
                    "learning/export.py", "learning/mpcnet.py", "learning/robots.py"]


@pytest.mark.parametrize("module", LEARNING_MODULES)
def test_learning_modules_are_present_and_imported(fresh_import, module):
    """MPC-Net's six modules exist and are among the modules the fresh
    interpreter imported without JAX or the JAX package."""
    proc, _ = fresh_import
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split("MODULES", 1)[1].split()
    assert (PKG / module).exists()
    assert "ocs2_tpu_torch." + module[:-3].replace("/", ".") in names


@pytest.mark.parametrize("module", LEARNING_MODULES)
def test_learning_modules_name_no_flax_or_optax(module):
    """The JAX package's MPC-Net is flax and optax; the port's imports
    neither (nor JAX, nor the JAX package)."""
    tree = ast.parse((PKG / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "ocs2_tpu", "flax", "optax"), (
                f"{module}: import of {mod}")


def test_learning_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.learning import memory, mpcnet, policy, robots

    fns = [
        memory.CircularMemory.create, policy.dense, policy.LinearPolicy,
        policy.NonlinearPolicy, policy.MixtureOfNonlinearExpertsPolicy,
        policy.MixtureOfLinearExpertsPolicy, mpcnet.Mpcnet, robots.make_ballbot_mpcnet,
        robots.make_legged_mpcnet, convert.mpcnet_sample_from_numpy,
    ]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
