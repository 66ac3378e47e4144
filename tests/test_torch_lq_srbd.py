"""K10 (``csrc/lq_srbd.cu``, ``ops/lq_srbd_cuda.py``,
``models/legged_robot/lq_kernel.py``): the legged SRBD problem's whole LQ
approximation in one kernel, and the rule by which ``oc/approx.approximate_lq``
hands it a call.

On the CPU: the dispatch rule over problems and inputs, the path and
variant counters, the wrapper's refusals (no card, no launch), the library's
name, and the kernel's source built for the host by g++ and held against the
generic path in both variants, the soft cone's and the hard cone's that
``ipm.solve`` hands it (every leaf of ``LQData``, rtol 2e-4 / atol 1e-5, the
port's kernel tolerances).  On the card (marker ``card``, skipped without
CUDA; this file imports no JAX): K10 against the generic path on the card,
``sqp.solve`` and ``ipm.solve`` on 256 starts through each path.  On a
machine with a card: ``python -m pytest --noconftest -m card
tests/test_torch_lq_srbd.py``."""
import ctypes
import dataclasses
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ocs2_tpu_torch.models import ballbot
from ocs2_tpu_torch.models.legged_robot import constraints as con
from ocs2_tpu_torch.models.legged_robot import gait, interface, loopshaping_mpc, model
from ocs2_tpu_torch.models.legged_robot.gait import contact_flags
from ocs2_tpu_torch.oc import approx
from ocs2_tpu_torch.oc.problem import soft_constraint
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from ocs2_tpu_torch.ops import _build, lq_srbd_cuda
from ocs2_tpu_torch.solvers import al, ipm, sqp
from ocs2_tpu_torch.core import penalties as pen

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
LEAVES = (
    "cost.f", "cost.dfdx", "cost.dfdu", "cost.dfdxx", "cost.dfdux", "cost.dfduu",
    "dynamics.f", "dynamics.dfdx", "dynamics.dfdu", "eq.f", "eq.dfdx", "eq.dfdu",
)
HARD_LEAVES = LEAVES + ("ineq.f", "ineq.dfdx", "ineq.dfdu")  # the hard variant's


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def trot_grid(n: int):
    ms = gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
    return make_time_grid(0.0, 1.0, n, event_times=ms.event_times, mode_sequence=ms.mode_sequence)


def lq_inputs(batch: int, n: int, seed: int, device="cpu"):
    """(grid, xs, us, params) on the trot grid (both modes): scenario 0 at
    the stand with the weight-compensating forces, the others perturbed, with
    stance forces from 1 N to 150 N, so that cone rows fall on both sides of
    the barrier's delta."""
    rng = np.random.default_rng(seed)
    grid = trot_grid(n)
    x = np.asarray(model.default_state("cpu"))[None, None] + 0.05 * rng.standard_normal(
        (batch, n + 1, 24))
    u = np.asarray(model.weight_compensating_input(np.ones(4, np.float32), "cpu"))[None, None] + (
        np.concatenate([5.0 * rng.standard_normal((batch, n, 12)),
                        0.5 * rng.standard_normal((batch, n, 12))], axis=-1))
    fz = u[..., 2:12:3]
    u[..., 2:12:3] = np.where(rng.random(fz.shape) < 0.3, rng.uniform(1.0, 8.0, fz.shape),
                              rng.uniform(20.0, 150.0, fz.shape))
    x[0] = np.asarray(model.default_state("cpu"))
    u[0] = np.asarray(model.weight_compensating_input(np.ones(4, np.float32), "cpu"))
    T = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
    params = interface.make_params(grid, device=device)
    return grid, T(x), T(u), params


def with_al(problem, params, batch: int, n: int):
    """``params`` with the AL state of a batch, as ``ipm.solve`` hands
    ``approximate_lq`` (leading [B]; no term of these problems reads it)."""
    device = params["swing_z"].device
    dims = problem.constraint_dims(approx.example_params(params, device), device=device)
    return dict(params, al=al.AlState.init(dims, n, batch=(batch,), device=device))


def flat(lq) -> dict:
    return {f"{name}.{f}": v for name, rec in lq._asdict().items() if rec is not None
            for f, v in rec._asdict().items() if v is not None}


def assert_lq_close(mine: dict, ref: dict, leaves=LEAVES):
    assert sorted(mine) == sorted(ref) == sorted(leaves)
    for leaf in leaves:
        a, b = mine[leaf].cpu().numpy(), ref[leaf].cpu().numpy()
        assert a.shape == b.shape, leaf
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=leaf)


# -- the dispatch rule -----------------------------------------------------------------------


def _added_term(p):
    return p.add(state_cost_terms=(soft_constraint(
        con._swing_height_error, pen.quadratic(1.0), with_input=False),))


PROBLEMS = {
    "srbd_soft_projected": lambda: interface.make_problem(device="cpu"),
    "sqp_augmented": lambda: al.augment_problem(
        interface.make_problem(device="cpu"), project_equalities=True),
    "hard_cone": lambda: interface.make_problem(friction_cone="hard", device="cpu"),
    # The problem ipm.solve approximates each iteration (the foot constraint projected).
    "ipm_augmented_hard": lambda: ipm.augment(
        interface.make_problem(friction_cone="hard", device="cpu"), project=True),
    # SQP's: the cone an augmented-Lagrangian cost term.
    "sqp_augmented_hard": lambda: al.augment_problem(
        interface.make_problem(friction_cone="hard", device="cpu"), project_equalities=True),
    "ipm_unprojected_hard": lambda: ipm.augment(
        interface.make_problem(friction_cone="hard", device="cpu"), project=False),
    "unprojected": lambda: interface.make_problem(project_foot_constraint=False, device="cpu"),
    "comkino": lambda: interface.make_problem(model_type="comkino", device="cpu"),
    "full": lambda: interface.make_problem(model_type="full", device="cpu"),
    "loopshaping": lambda: loopshaping_mpc.make_loopshaping_problem(device="cpu")[0],
    "added_term": lambda: _added_term(interface.make_problem(device="cpu")),
    "ddp_augmented": lambda: al.augment_problem(interface.make_problem(device="cpu")),
    "ballbot": lambda: ballbot.make_problem(device="cpu"),
}
CUDA, F32 = torch.device("cuda"), torch.float32

# (problem, params entries, method, substeps, device, dtype) -> whether K10
# takes the call.
DISPATCH = {
    "eligible_rk2": ("srbd_soft_projected", {}, "rk2", 1, CUDA, F32, True),
    "eligible_RK2": ("srbd_soft_projected", {}, "RK2", 1, CUDA, F32, True),
    "sqp_augmented": ("sqp_augmented", {"al": None}, "rk2", 1, CUDA, F32, True),
    "rk2_substeps": ("srbd_soft_projected", {}, "rk2", 2, CUDA, F32, False),
    "rk4": ("srbd_soft_projected", {}, "rk4", 1, CUDA, F32, False),
    "euler": ("srbd_soft_projected", {}, "euler", 1, CUDA, F32, False),
    "hard_cone": ("hard_cone", {}, "rk2", 1, CUDA, F32, True),
    "ipm_augmented_hard": ("ipm_augmented_hard", {"al": None}, "rk2", 1, CUDA, F32, True),
    "sqp_augmented_hard": ("sqp_augmented_hard", {"al": None}, "rk2", 1, CUDA, F32, False),
    "ipm_unprojected_hard": ("ipm_unprojected_hard", {"al": None}, "rk2", 1, CUDA, F32, False),
    "hard_cone_rk4": ("ipm_augmented_hard", {"al": None}, "rk4", 1, CUDA, F32, False),
    "hard_cone_cpu": ("ipm_augmented_hard", {"al": None}, "rk2", 1, torch.device("cpu"), F32,
                      False),
    "unprojected": ("unprojected", {}, "rk2", 1, CUDA, F32, False),
    "comkino": ("comkino", {}, "rk2", 1, CUDA, F32, False),
    "full": ("full", {}, "rk2", 1, CUDA, F32, False),
    "loopshaping": ("loopshaping", {}, "rk2", 1, CUDA, F32, False),
    "added_term": ("added_term", {}, "rk2", 1, CUDA, F32, False),
    "ddp_augmented": ("ddp_augmented", {"al": None}, "rk2", 1, CUDA, F32, False),
    "ballbot": ("ballbot", {}, "rk2", 1, CUDA, F32, False),
    "scenario_entry": ("srbd_soft_projected", {"scenario": {}}, "rk2", 1, CUDA, F32, False),
    "cpu_tensors": ("srbd_soft_projected", {}, "rk2", 1, torch.device("cpu"), F32, False),
    "float64": ("srbd_soft_projected", {}, "rk2", 1, CUDA, torch.float64, False),
    "ode45": ("srbd_soft_projected", {}, "ode45", 1, CUDA, F32, False),
}


@pytest.mark.parametrize("case", DISPATCH)
def test_dispatch_rule(case):
    name, extra, method, substeps, device, dtype, takes = DISPATCH[case]
    problem = PROBLEMS[name]()
    params = dict(interface.make_params(trot_grid(14), device="cpu"), **extra)
    assert approx.kernel_takes(problem, params, method, substeps, device, dtype) is takes


def test_cpu_calls_take_the_generic_path_and_are_counted():
    grid, xs, us, params = lq_inputs(2, 14, seed=1)
    problem = interface.make_problem(device="cpu")
    before, variants = dict(approx.path_counts), dict(approx.variant_counts)
    launches = lq_srbd_cuda.launch_count
    lq = approx.approximate_lq(problem, grid, xs, us, params, method="rk2")
    assert approx.path_counts == {"kernel": before["kernel"], "generic": before["generic"] + 1}
    assert approx.variant_counts == variants
    assert lq_srbd_cuda.launch_count == launches
    # The generic path is the private function, bit for bit.
    ref = approx._approximate_lq_generic(problem, grid, xs, us, params, "rk2")
    for leaf, v in flat(lq).items():
        assert torch.equal(v, flat(ref)[leaf]), leaf


# -- the wrapper ------------------------------------------------------------------------------


def _good(batch=2, n=6):
    grid, xs, us, params = lq_inputs(batch, n, seed=2)
    k10 = interface.make_problem(device="cpu").lq_kernel
    return dict(xs=xs, us=us, nodes=k10.node_inputs(grid.device("cpu"), params),
                weights=k10.weights, constants=k10.constants)


def _nodes(**kw):
    return lambda a: dict(a, nodes=a["nodes"]._replace(**kw))


BREAKAGES = {
    "xs_float64": (lambda a: dict(a, xs=a["xs"].double()), TypeError, "xs must be"),
    "xs_width": (lambda a: dict(a, xs=a["xs"][..., :12].contiguous()), ValueError, "xs must be"),
    "us_horizon": (lambda a: dict(a, us=a["us"][:, :-1].contiguous()), ValueError, "us must be"),
    "us_strided": (lambda a: dict(a, us=a["us"].transpose(0, 1).contiguous().transpose(0, 1)),
                   ValueError, "us must be contiguous"),
    "modes_int64": (lambda a: _nodes(modes=a["nodes"].modes.long())(a), TypeError, "modes"),
    "x_ref_rows": (lambda a: _nodes(x_ref=a["nodes"].x_ref[:-1])(a), ValueError, "x_ref"),
    "dt_length": (lambda a: _nodes(dt=a["nodes"].dt[:-1])(a), ValueError, "dt"),
    "Q_float64": (lambda a: dict(a, weights=a["weights"]._replace(Q=a["weights"].Q.double())),
                  TypeError, "Q must be"),
    "constants": (lambda a: dict(a, constants=a["constants"][:-1]), ValueError, "constants"),
    "swing_z_device": (lambda a: _nodes(swing_z=a["nodes"].swing_z.to("meta"))(a), ValueError,
                       "swing_z is on meta"),
    "empty_batch": (lambda a: dict(a, xs=a["xs"][:0], us=a["us"][:0]), ValueError, "empty"),
    "cpu": (lambda a: a, ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("breakage", BREAKAGES)
def test_wrapper_refuses_bad_inputs_without_a_card(breakage):
    broken, exc, match = BREAKAGES[breakage]
    before = lq_srbd_cuda.launch_count
    with pytest.raises(exc, match=match):
        lq_srbd_cuda.lq_srbd_cuda(**broken(_good()))
    assert lq_srbd_cuda.launch_count == before


def test_library_name_changes_with_the_source(tmp_path, monkeypatch):
    src = (_build.CSRC_DIR / lq_srbd_cuda.SOURCE).read_text()
    ((source, defines),) = lq_srbd_cuda.build_jobs()
    first = _build.library_path(source, defines)
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert first.name.startswith("liblq_srbd_")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / source).write_text(src)
    assert _build.library_path(source, defines) == first
    (tmp_path / source).write_text(src + "\n// edited\n")
    assert _build.library_path(source, defines) != first


# -- the kernel's source on the host ----------------------------------------------------------

_HOST_MAIN = r"""
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
thread_local std::barrier<>* t_node_barrier;
void k10_host_sync() { t_node_barrier->arrive_and_wait(); }
#include "lq_srbd.cu"
extern "C" int host_num_constants() { return k10::kNumConstants; }
// Every node of the batch in turn, its 48 threads host threads that meet on
// the node's barrier; shared memory filled with NaN before the node.
// The hard variant where `hard` is not 0 (out[12 ... 14] its ineq arrays,
// else null).
extern "C" void host_run(const float* const* in, float* const* out, int batch, int n,
                         const float* constants, int hard) {
  k10::Args a{in[0], in[1], in[2], in[3], reinterpret_cast<const int*>(in[4]), in[5], in[6],
              in[7], in[8], in[9], in[10], in[11], out[0], out[1], out[2], out[3], out[4],
              out[5], out[6], out[7], out[8], out[9], out[10], out[11], out[12], out[13],
              out[14], batch, n, {}};
  std::memcpy(&a.k, constants, sizeof(k10::Constants));
  std::vector<float> sm(k10::kNodeFloats);
  for (long long i = 0; i < static_cast<long long>(batch) * (n + 1); ++i) {
    const k10::Node nd = k10::node_of(a, i);
    std::fill(sm.begin(), sm.end(), __builtin_nanf(""));
    std::barrier<> node(k10::kDirs);
    std::vector<std::thread> lanes;
    for (int t = 0; t < k10::kDirs; ++t) {
      lanes.emplace_back([&, t] {
        t_node_barrier = &node;
        if (hard) {
          k10::node_program<true>(a, nd, true, t, sm.data());
        } else {
          k10::node_program<false>(a, nd, true, t, sm.data());
        }
      });
    }
    for (auto& lane : lanes) lane.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source built by g++ for the host, with a main that runs
    each node's 48 threads as host threads on a barrier of their own."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("k10_host")
    shutil.copy(_build.CSRC_DIR / lq_srbd_cuda.SOURCE, d / lq_srbd_cuda.SOURCE)
    (d / "host_main.cpp").write_text(_HOST_MAIN)
    out = d / "libk10_host.so"
    built = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{d}",
         "-o", str(out), str(d / "host_main.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    lib.host_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p, ctypes.c_int]
    assert lib.host_num_constants() == len(lq_srbd_cuda.CONSTANTS)
    return lib


def host_launch(lib, xs, us, nodes, weights, constants, hard_cone=False):
    """``lq_srbd_cuda.lq_srbd_cuda`` with the kernel's source run on the host:
    the wrapper's own checks, outputs filled with 7.0 before the run."""
    lq_srbd_cuda.check_inputs(xs, us, nodes, weights, constants)
    batch, n = xs.shape[0], xs.shape[1] - 1
    res = lq_srbd_cuda.Results(*(None if s is None else torch.full(s, 7.0)
                                 for s in lq_srbd_cuda.result_shapes(batch, n, hard_cone)))
    ins = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in (xs, us, *nodes, *weights)))
    outs = (ctypes.c_void_p * 15)(*(None if t is None else t.data_ptr() for t in res))
    consts = (ctypes.c_float * len(constants))(*constants)
    lib.host_run(ctypes.addressof(ins), ctypes.addressof(outs), batch, n,
                 ctypes.addressof(consts), int(hard_cone))
    return res


def host_approximate(lib, monkeypatch, problem, grid, xs, us, params) -> dict:
    """K10's arithmetic on the host, through ``SrbdLqKernel.approximate`` and
    the wrapper's own checks."""
    monkeypatch.setattr(lq_srbd_cuda, "lq_srbd_cuda", functools.partial(host_launch, lib))
    return flat(problem.lq_kernel.approximate(grid, xs, us, params))


@pytest.mark.parametrize("cone", ["soft", "ipm_hard"])
@pytest.mark.parametrize("batch, n, seed", [(3, 14, 3), (2, 8, 6)])
def test_kernel_source_on_the_host_matches_the_generic_path(host_kernel, monkeypatch, cone,
                                                           batch, n, seed):
    """Every leaf of LQData (rk2 in one step) on the trot grid (jump
    intervals and both modes), at the stand and at perturbed states whose
    cone rows lie on both sides of the barrier's delta (soft) and of 0
    (hard), against ``_approximate_lq_generic`` on the CPU.  The hard cone's
    problem is the one ``ipm.solve`` approximates: its cost has no barrier,
    its ``ineq`` is the cone, with a state Jacobian of exact zeros."""
    grid, xs, us, params = lq_inputs(batch, n, seed=seed)
    soft = interface.make_problem(device="cpu")
    f = us[..., :12].reshape(batch, n, 4, 3)
    cone_rows = con.FRICTION_MU * f[..., 2] - torch.sqrt(
        f[..., 0] ** 2 + f[..., 1] ** 2 + con.CONE_EPS)
    stance = (contact_flags(grid.device("cpu").modes[:-1]) > 0.5).expand(batch, n, 4)
    if cone == "soft":
        problem, leaves, sides = soft, LEAVES, 5.0
    else:
        problem = ipm.augment(interface.make_problem(friction_cone="hard", device="cpu"), True)
        params = with_al(problem, params, batch, n)
        leaves, sides = HARD_LEAVES, 0.0
    assert bool((cone_rows[stance] < sides).any()) and bool((cone_rows[stance] > sides).any())
    mine = host_approximate(host_kernel, monkeypatch, problem, grid, xs, us, params)
    ref = flat(approx._approximate_lq_generic(problem, grid, xs, us, params, "rk2"))
    assert_lq_close(mine, ref, leaves)
    if cone == "ipm_hard":
        assert torch.equal(mine["ineq.dfdx"], torch.zeros_like(ref["ineq.dfdx"]))
        assert torch.equal(ref["ineq.dfdx"], torch.zeros_like(ref["ineq.dfdx"]))
        # The barrier is out of the cost: the stance forces' Hessian block
        # is R's alone, which the soft cone's barrier raises.
        with_barrier = approx._approximate_lq_generic(soft, grid, xs, us, params, "rk2")
        assert not torch.allclose(with_barrier.cost.dfduu, ref["cost.dfduu"],
                                  rtol=RTOL, atol=ATOL)


# (problem, method) of one call of approximate_lq -> the path and the variant
# it is counted under.
COUNTED = {
    "soft": ("srbd_soft_projected", "rk2", "kernel", "soft"),
    "hard": ("ipm_augmented_hard", "rk2", "kernel", "hard"),
    "generic": ("ipm_augmented_hard", "rk4", "generic", None),
}


@pytest.mark.parametrize("way", COUNTED)
def test_each_call_is_counted_by_path_and_variant(host_kernel, monkeypatch, way):
    """One call of ``approximate_lq`` each way, the kernel's source run on
    the host in place of the card's launch and the dispatch told the tensors
    are on a card: ``path_counts`` and ``variant_counts`` each count it once,
    where it went, and the LQData is the generic path's."""
    name, method, path, variant = COUNTED[way]
    problem = PROBLEMS[name]()
    grid, xs, us, params = lq_inputs(2, 8, seed=7)
    params = with_al(problem, params, 2, 8)
    takes = approx.kernel_takes
    monkeypatch.setattr(approx, "kernel_takes", lambda p, pr, m, s, device, dtype: takes(
        p, pr, m, s, CUDA, dtype))
    monkeypatch.setattr(lq_srbd_cuda, "lq_srbd_cuda", functools.partial(host_launch, host_kernel))
    paths, variants = dict(approx.path_counts), dict(approx.variant_counts)
    lq = flat(approx.approximate_lq(problem, grid, xs, us, params, method=method))
    paths[path] += 1
    if variant is not None:
        variants[variant] += 1
    assert approx.path_counts == paths and approx.variant_counts == variants
    ref = flat(approx._approximate_lq_generic(problem, grid, xs, us, params, method))
    assert_lq_close(lq, ref, HARD_LEAVES if name != "srbd_soft_projected" else LEAVES)


# -- on the card ------------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("cone", ["soft", "ipm_hard"])
@pytest.mark.parametrize("batch, n", [(1, 100), (256, 100), (4, 14)])
def test_k10_matches_the_generic_path_on_the_card(card, cone, batch, n):
    grid, xs, us, params = lq_inputs(batch, n, seed=4, device=card)
    if cone == "soft":
        problem, leaves = interface.make_problem(device=card), LEAVES
    else:
        problem = ipm.augment(interface.make_problem(friction_cone="hard", device=card), True)
        params, leaves = with_al(problem, params, batch, n), HARD_LEAVES
    before, launches = dict(approx.variant_counts), lq_srbd_cuda.launch_count
    mine = approx.approximate_lq(problem, grid, xs, us, params, "rk2")
    assert approx.variant_counts[problem.lq_kernel.variant] == (
        before[problem.lq_kernel.variant] + 1)
    assert lq_srbd_cuda.launch_count == launches + 1
    assert lq_srbd_cuda.last_launch_dims == (batch, n)
    ref = approx._approximate_lq_generic(problem, grid, xs, us, params, "rk2")
    torch.cuda.synchronize()
    assert_lq_close(flat(mine), flat(ref), leaves)


@pytest.mark.card
def test_sqp_solve_through_each_path_on_the_card(card):
    """256 starts about the stand (1e-3 N(0, 1), the cell's traffic) through
    K10 and through the generic path: equal iterations, and xs / us within
    the cell's check limits (1e-5 and 5e-5 of the largest entry)."""
    grid = trot_grid(100)
    problem = interface.make_problem(device=card)
    params = interface.make_params(grid, device=card)
    rng = np.random.default_rng(5)
    x0 = model.default_state(card)[None] + 1e-3 * torch.as_tensor(
        rng.standard_normal((256, 24)), dtype=torch.float32, device=card)
    us0 = model.weight_compensating_input(np.ones(4, np.float32), card)[None].expand(100, 24)
    settings = sqp.SqpSettings(max_iterations=10, integrator="rk2")
    launches = lq_srbd_cuda.launch_count
    mine = sqp.solve(problem, grid, x0, params, us_init=us0, settings=settings, device=card)
    assert lq_srbd_cuda.launch_count > launches
    generic = dataclasses.replace(problem, lq_kernel=None)
    ref = sqp.solve(generic, grid, x0, params, us_init=us0, settings=settings, device=card)
    assert torch.equal(mine.iterations, ref.iterations)
    for field, limit in (("xs", 1e-5), ("us", 5e-5)):
        a, b = getattr(mine, field).flatten(1), getattr(ref, field).flatten(1)
        gap = ((a - b).abs().amax(1) / b.abs().amax(1)).max()
        assert float(gap) <= limit, (field, float(gap))


@pytest.mark.card
def test_ipm_solve_through_each_path_on_the_card(card):
    """256 starts about the stand (1e-3 N(0, 1), the IPM cell's traffic) under
    ``ipm.solve`` with the hard cone, through K10's hard variant and through
    the generic path.  IPM's stop sits on float32's floor (PERF.md), so a
    scenario may stop one iteration apart at equal merit: at most the cell's
    share of 0.7 of them, merits within 1e-5 of each other, and xs / us
    within the cell's limits (1e-5 and 5e-5 of the largest entry) where the
    iterations agree."""
    grid = trot_grid(100)
    problem = interface.make_problem(friction_cone="hard", device=card)
    params = interface.make_params(grid, device=card)
    rng = np.random.default_rng(8)
    x0 = model.default_state(card)[None] + 1e-3 * torch.as_tensor(
        rng.standard_normal((256, 24)), dtype=torch.float32, device=card)
    us0 = model.weight_compensating_input(np.ones(4, np.float32), card)[None].expand(100, 24)
    settings = ipm.IpmSettings(max_iterations=15, integrator="rk2")
    hard = approx.variant_counts["hard"]
    mine = ipm.solve(problem, grid, x0, params, us_init=us0, settings=settings, device=card)
    assert approx.variant_counts["hard"] == hard + int(mine.iterations.max())
    generic = dataclasses.replace(problem, lq_kernel=None)
    ref = ipm.solve(generic, grid, x0, params, us_init=us0, settings=settings, device=card)
    assert approx.variant_counts["hard"] == hard + int(mine.iterations.max())
    same = mine.iterations == ref.iterations
    assert float((~same).float().mean()) <= 0.7
    merit_gap = (mine.performance.merit - ref.performance.merit).abs() / ref.performance.merit.abs()
    assert float(merit_gap.max()) <= 1e-5
    for field, limit in (("xs", 1e-5), ("us", 5e-5)):
        a, b = getattr(mine, field)[same].flatten(1), getattr(ref, field)[same].flatten(1)
        gap = ((a - b).abs().amax(1) / b.abs().amax(1)).max()
        assert float(gap) <= limit, (field, float(gap))
