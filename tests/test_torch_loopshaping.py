"""Loopshaping in the port (``oc/loopshaping.py``,
``models/legged_robot/loopshaping_mpc.py``) vs the JAX package, on the CPU.

Held here: the definitions and their transfer functions (the legged robot's
r_filter realization, ``first_order_filter``, both ``.info`` grammars of
``load_loopshaping_info``), the wrapped problems' dynamics, costs and
constraints on seeded inputs for the output and eliminate patterns and the
r_filter route, their ``cost_structure_psd`` (False: the wrapped terms are
plain closures in both packages, so SQP runs its Hessian correction), the
three double-integrator solves of ``tests/test_components.py::TestLoopshaping``
as live parity, the legged loopshaping LQ data at full width (nx = 48) on a
short grid against the JAX package's ``approximate_lq``, and the legged trot
solve at 3 iterations and the first tick of the closed loop against the
JAX package's record (``tests/torch_data/loopshaping_reference.npz``,
``tools/loopshaping_reference.py --record``), which holds the 12-iteration
solve and the whole loop for the card; these two with the Hessian
correction's eigh in float64 in both packages, where float32 rounding no
longer decides the solution.

Tolerances: matrices and transfers exact or rtol 1e-6 (the same float32
constants); function values rtol 1e-5 / atol 1e-6 (the same operations in
another order); LQ leaves rtol 2e-4 / atol 1e-5 times the leaf's largest
entry (two AD systems over rk2 with 2 substeps, as
``tests/test_torch_legged_model.py``); solves 1e-3 + 1e-4 |value| with equal
iterations, or within the JAX package's own spread where its routes part by
more (``chip_smoke.hold_within_spread``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.models.legged_robot import loopshaping_mpc as jlm
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.oc import loopshaping as jls
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import sqp as jsqp

import chip_smoke
from tools import loopshaping_reference
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.models.legged_robot import interface, model
from ocs2_tpu_torch.models.legged_robot import loopshaping_mpc as lm
from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
from ocs2_tpu_torch.oc import approx
from ocs2_tpu_torch.oc import loopshaping as ls
from ocs2_tpu_torch.oc.time_discretization import make_time_grid, uniform_grid
from ocs2_tpu_torch.solvers import al, sqp

FN_RTOL, FN_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The legged solves at nx = 48 are many small ops: one intra-op thread
    runs them as fast alone and 15-25x faster beside the suite's other
    workers (3.8 s against 66 s for the loop's first tick)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
LQ_RTOL, LQ_ATOL = 2e-4, 1e-5
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731


def transfer(defn, w, n):
    A, B, C, D = (np.asarray(m, np.complex128) for m in (defn.A, defn.B, defn.C, defn.D))
    return D + C @ np.linalg.inv(w * np.eye(n) - A) @ B


def same_definition(mine, ref):
    for f in ("A", "B", "C", "D", "R_v"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.float32, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


# -- definitions and their transfers -------------------------------------------


def test_definition_realizes_s_inv_transfer():
    """The legged robot's r_filter realization equals the JAX package's, and
    its u -> y transfer is the .info's s_inv(s) = g s / (s + p) per channel,
    with zero DC gain (constant inputs are free)."""
    defn = lm.anymal_loopshaping_definition(device="cpu")
    same_definition(defn, jlm.anymal_loopshaping_definition())
    w = 7.0j
    H = transfer(defn, w, 24)
    np.testing.assert_allclose(H[0, 0], 4.0 * w / (w + 100.0), rtol=1e-6)
    np.testing.assert_allclose(H[12, 12], 3.0 * w / (w + 50.0), rtol=1e-6)
    np.testing.assert_allclose(transfer(defn, 0.0, 24), 0.0, atol=1e-6)


def test_augment_state_steady_matches_jax():
    defn = lm.anymal_loopshaping_definition(device="cpu")
    jdefn = jlm.anymal_loopshaping_definition()
    u = model.weight_compensating_input(np.ones(4), "cpu")
    xa = lm.augment_state(defn, model.default_state("cpu"), u)
    ref = jlm.augment_state(jdefn, jmodel.default_state(), jmodel.weight_compensating_input(
        jnp.ones(4)))
    assert xa.shape == (48,)
    np.testing.assert_allclose(xa.numpy(), np.asarray(ref), rtol=FN_RTOL, atol=FN_ATOL)
    # The equilibrium low-pass state is the input; the filtered output is zero.
    np.testing.assert_allclose(xa[24:].numpy(), u.numpy(), atol=1e-4)
    y = lm.filtered_output(defn, xa.expand(2, 48), u[None])
    np.testing.assert_allclose(y.numpy(), 0.0, atol=1e-3)
    # Batch-polymorphic: a batch of inputs gives the rows one by one.
    us = torch.stack([u, 2.0 * u])
    np.testing.assert_allclose(lm.augment_state(defn, model.default_state("cpu").expand(2, 24),
                                                us)[1].numpy(),
                               lm.augment_state(defn, model.default_state("cpu"),
                                                2.0 * u).numpy(), rtol=1e-6)


def test_first_order_filter_and_observation_match_jax():
    defn = ls.first_order_filter(3, pole=20.0, zero=2.0, gain=1.5, device="cpu")
    jdefn = jls.first_order_filter(3, pole=20.0, zero=2.0, gain=1.5)
    same_definition(defn, jdefn)
    assert defn.num_filter_states == 3 and defn.num_filtered_inputs == 3
    rng = np.random.default_rng(3)
    x, u = rng.standard_normal(2).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    xa = ls.augment_observation(defn, T(x), T(u))
    ref = jls.augment_observation(jdefn, jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(xa.numpy(), np.asarray(ref), rtol=FN_RTOL, atol=FN_ATOL)
    plant, xi = ls.split_state(defn, xa)
    jplant, jxi = jls.split_state(jdefn, ref)
    np.testing.assert_array_equal(plant.numpy(), np.asarray(jplant))
    np.testing.assert_allclose(xi.numpy(), np.asarray(jxi), rtol=FN_RTOL, atol=FN_ATOL)
    np.testing.assert_allclose(defn.filter_input(xi, T(u)).numpy(),
                               np.asarray(jdefn.filter_input(jxi, jnp.asarray(u))),
                               rtol=FN_RTOL, atol=FN_ATOL)


S_INV_INFO = """
s_inv_filter
{
    numFilters 2;

    Filter0
    {
        numRepeats  12;
        numPoles    1;
        numZeros    1;
        scaling     4;
        zeros
        {
           (0)    0.0;
        }
        poles
        {
           (0) -100.0;
        }
    }

    Filter1
    {
        numRepeats  12;
        numPoles    1;
        numZeros    1;
        scaling     3;
        zeros
        {
           (0) 0.0;
        }
        poles
        {
           (0) -50.0;
        }
    }
}
"""

R_INFO = """
r_filter
{
    numFilters 1;
    Filter0
    {
        numRepeats 2;
        scaling    2.0;
        zeros
        {
            (0) 0.0;
        }
        poles
        {
            (0) -30.0;
        }
    }
}
"""


def test_load_loopshaping_info_s_inv_filter():
    """s_inv_filter sections are inverted and select the eliminate pattern
    (LoopshapingPropertyTree.cpp:143-160)."""
    defn, pattern = ls.load_loopshaping_info(S_INV_INFO, device="cpu")
    jdefn, jpattern = jls.load_loopshaping_info(S_INV_INFO)
    assert pattern == jpattern == "eliminate"
    same_definition(defn, jdefn)
    w = 5.0j
    H = transfer(defn, w, 24)
    np.testing.assert_allclose(H[0, 0], (w + 100.0) / (4.0 * w), rtol=1e-6)
    np.testing.assert_allclose(H[12, 12], (w + 50.0) / (3.0 * w), rtol=1e-6)


def test_load_loopshaping_info_r_filter_and_a_file(tmp_path):
    defn, pattern = ls.load_loopshaping_info(R_INFO, device="cpu")
    jdefn, jpattern = jls.load_loopshaping_info(R_INFO)
    assert pattern == jpattern == "output"
    same_definition(defn, jdefn)
    w = 3.0j
    np.testing.assert_allclose(transfer(defn, w, 2)[0, 0], 2.0 * w / (w + 30.0), rtol=1e-6)
    path = tmp_path / "loopshaping.info"
    path.write_text(R_INFO)
    from_file, _ = ls.load_loopshaping_info(str(path), device="cpu")
    same_definition(from_file, jdefn)


@pytest.mark.parametrize("text, match", [
    (S_INV_INFO + R_INFO, "both r and s filter"), ("mpc\n{\n  x 1\n}\n", "no valid"),
])
def test_load_loopshaping_info_refuses_as_jax(text, match):
    with pytest.raises(ValueError, match=match):
        ls.load_loopshaping_info(text, device="cpu")
    with pytest.raises(ValueError, match=match):
        jls.load_loopshaping_info(text)


# -- wrapped problems: terms on seeded inputs ----------------------------------


def _di_defn(proper):
    """(port, JAX) definitions on the double integrator's one input: D = 0
    (strictly proper: both patterns) or D = 0.5 (output only)."""
    d = 0.0 if proper else 0.5
    mats = dict(A=-5.0 * np.eye(1), B=5.0 * np.eye(1), C=np.eye(1), D=d * np.eye(1),
                R_v=0.01 * np.eye(1))
    return (ls.LoopshapingDefinition(**{k: T(v) for k, v in mats.items()}),
            jls.LoopshapingDefinition(**{k: jnp.asarray(v, jnp.float32)
                                         for k, v in mats.items()}))


def _extra_terms(lib, cat):
    """An equality, an inequality and a state-only cost of the plant, the
    same formula in each package, so that every slot of the wrapper is
    exercised."""
    def eq(t, x, u, p):
        return cat([x[..., 0:1] + 0.5 * u[..., 0:1] - 0.1 * t[..., None]])

    def ineq(t, x, u, p):
        return cat([1.0 - u[..., 0:1] * u[..., 0:1], 2.0 + x[..., 1:2]])

    def state_cost(t, x, p):
        return lib.sum(x * x, -1) * 0.25

    return dict(equality_terms=(eq,), inequality_terms=(ineq,), state_cost_terms=(state_cost,))


def _di_problems(pattern, route, proper=True):
    mine_p = di.make_problem(device="cpu")
    ref_p = jdi.make_problem()
    mine_p = mine_p.add(**_extra_terms(torch, lambda v: torch.cat(v, -1)))
    ref_p = ref_p.add(**_extra_terms(jnp, lambda v: jnp.concatenate(v, -1)))
    defn, jdefn = _di_defn(proper)
    if route == "r_filter":
        return ls.wrap_problem_r_filter(mine_p, defn), jls.wrap_problem_r_filter(ref_p, jdefn)
    return ls.wrap_problem(mine_p, defn, pattern), jls.wrap_problem(ref_p, jdefn, pattern)


WRAPS = [("output", "wrap", True), ("output", "wrap", False), ("eliminate", "wrap", True),
         ("output", "r_filter", False)]


@pytest.mark.parametrize("pattern, route, proper", WRAPS,
                         ids=["output_proper", "output_D", "eliminate", "r_filter"])
def test_wrapped_terms_match_jax(pattern, route, proper):
    """Dynamics, running / state / final cost, equality and inequality of a
    wrapped double integrator (with an equality, an inequality and a state
    cost added) at 6 seeded (t, x_aug, v): per sample as in the JAX package,
    and the same values when the port is called on the whole batch at once."""
    mine, ref = _di_problems(pattern, route, proper)
    assert (mine.nx, mine.nu) == (ref.nx, ref.nu) == (3, 1)
    for slot in ("cost_terms", "state_cost_terms", "final_cost_terms", "equality_terms",
                 "inequality_terms", "state_equality_terms", "state_inequality_terms"):
        assert len(getattr(mine, slot)) == len(getattr(ref, slot)), slot
    rng = np.random.default_rng(11)
    ts = rng.uniform(0.0, 2.0, 6).astype(np.float32)
    xs = rng.standard_normal((6, 3)).astype(np.float32)
    vs = rng.standard_normal((6, 1)).astype(np.float32)
    p, jp = di.make_params(device="cpu"), jdi.make_params()
    evals = {
        "dynamics": (lambda P, t, x, v, q: P.dynamics(t, x, v, q)),
        "cost": (lambda P, t, x, v, q: P.cost(t, x, v, q)),
        "final_cost": (lambda P, t, x, v, q: P.final_cost(t, x, q)),
        "equality": (lambda P, t, x, v, q: P.equality(t, x, v, q)),
        "inequality": (lambda P, t, x, v, q: P.inequality(t, x, v, q)),
        "state_equality": (lambda P, t, x, v, q: P.state_equality(t, x, q)),
        "state_inequality": (lambda P, t, x, v, q: P.state_inequality(t, x, q)),
    }
    for name, fn in evals.items():
        batch = fn(mine, T(ts), T(xs), T(vs), p)
        for i in range(6):
            a = fn(mine, T(ts[i]), T(xs[i]), T(vs[i]), p)
            b = fn(ref, jnp.asarray(ts[i]), jnp.asarray(xs[i]), jnp.asarray(vs[i]), jp)
            assert (a is None) == (b is None), name
            if a is None:
                continue
            a = torch.as_tensor(a)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FN_RTOL, atol=FN_ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(torch.as_tensor(batch)[i].numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("pattern, route, proper", WRAPS,
                         ids=["output_proper", "output_D", "eliminate", "r_filter"])
def test_wrapped_problem_is_not_psd_by_structure_as_in_jax(pattern, route, proper):
    """The wrapped terms are plain closures: no ``quad_approx``, so the LQ
    approximation takes them through exact AD and ``cost_structure_psd`` is
    False in both packages (the unwrapped double integrator's is True)."""
    mine, ref = _di_problems(pattern, route, proper)
    assert mine.cost_structure_psd is False and ref.cost_structure_psd is False
    for term in mine.cost_terms + mine.state_cost_terms + mine.final_cost_terms:
        assert not hasattr(term, "quad_approx")
    assert di.make_problem(device="cpu").cost_structure_psd and jdi.make_problem().cost_structure_psd
    lp, _ = lm.make_loopshaping_problem(device="cpu")
    assert lp.cost_structure_psd is False and jlm.make_loopshaping_problem()[0].cost_structure_psd \
        is False
    assert (lp.nx, lp.nu) == (48, 24)


def test_eliminate_pattern_classification_and_checks():
    mine, _ = _di_problems("eliminate", "wrap")
    assert mine.equality_terms == () and mine.inequality_terms == ()
    assert len(mine.state_equality_terms) == 1 and len(mine.state_inequality_terms) == 1
    # The original running cost and the added state cost are state terms.
    assert len(mine.state_cost_terms) == 2 and len(mine.cost_terms) == 1
    improper, _ = _di_defn(proper=False)
    problem = di.make_problem(device="cpu")
    with pytest.raises(AssertionError):
        ls.wrap_problem(problem, improper, pattern="eliminate")
    with pytest.raises(AssertionError):
        ls.wrap_problem(problem, improper._replace(D=torch.zeros(1, 1), R_v=None),
                        pattern="eliminate")
    with pytest.raises(ValueError, match="pattern"):
        ls.wrap_problem(problem, improper, pattern="input")


def test_wrapped_jump_map_keeps_the_filter_state():
    defn, _ = _di_defn(proper=True)
    problem = di.make_problem(device="cpu").add(
        jump_map=lambda t, x, p: torch.cat([-x[..., 0:1], x[..., 1:2]], -1))
    for wrapped in (ls.wrap_problem(problem, defn), ls.wrap_problem_r_filter(problem, defn)):
        xa = T([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        np.testing.assert_array_equal(wrapped.apply_jump(0.0, xa, {}).numpy(),
                                      [[-1.0, 2.0, 3.0], [-4.0, 5.0, 6.0]])


# -- the double-integrator solves of tests/test_components.py -------------------


def _solve_both(mine_p, ref_p, x0):
    grid, jgrid = uniform_grid(0.0, 2.0, 40), juniform_grid(0.0, 2.0, 40)
    mine = sqp.solve(mine_p, grid, T(x0), di.make_params(device="cpu"), device="cpu")
    ref = jax.jit(lambda x: jsqp.solve(ref_p, jgrid, x, jdi.make_params()))(jnp.asarray(x0))
    return mine, ref


def _same_solve(mine, ref):
    assert int(mine.iterations[0]) == int(ref.iterations)
    for f in ("xs", "us"):
        a, b = getattr(mine, f)[0].numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, rtol=chip_smoke.SOLVE_RTOL, atol=chip_smoke.SOLVE_ATOL,
                                   err_msg=f)


def test_all_pass_augmented_solve_matches_jax_and_the_unfiltered_solve():
    """An all-pass filter (C = 0, D = I): the augmented solve reproduces the
    unfiltered one (tests/test_components.py:31-63), and both are the JAX
    package's."""
    defn = ls.LoopshapingDefinition(A=-10.0 * torch.eye(1), B=torch.eye(1), C=torch.zeros(1, 1),
                                    D=torch.eye(1))
    jdefn = jls.LoopshapingDefinition(A=-10.0 * jnp.eye(1), B=jnp.eye(1), C=jnp.zeros((1, 1)),
                                      D=jnp.eye(1))
    x0_aug = ls.augment_observation(defn, T([1.0, 0.0]), torch.zeros(1)).numpy()
    mine, ref = _solve_both(ls.wrap_problem(di.make_problem(device="cpu"), defn),
                            jls.wrap_problem(jdi.make_problem(), jdefn), x0_aug)
    _same_solve(mine, ref)
    plain, _ = _solve_both(di.make_problem(device="cpu"), jdi.make_problem(), [1.0, 0.0])
    np.testing.assert_allclose(mine.xs[0, :, :2].numpy(), plain.xs[0].numpy(), atol=2e-2)


@pytest.mark.parametrize("pattern", ["output", "eliminate"])
def test_strictly_proper_filter_solves_match_jax(pattern):
    """The filter-smoothing solve (D = 0, tests/test_components.py:65-87) in
    the output pattern and its eliminate-pattern twin (:94-122): each equal
    to the JAX package's, the plant input starting at the given xi0 and the
    two patterns' plant trajectories within the JAX test's 2e-2."""
    defn, jdefn = _di_defn(proper=True)
    x0 = [1.0, 0.0, 0.0]
    mine, ref = _solve_both(ls.wrap_problem(di.make_problem(device="cpu"), defn, pattern),
                            jls.wrap_problem(jdi.make_problem(), jdefn, pattern), x0)
    _same_solve(mine, ref)
    _, xi0 = ls.split_state(defn, mine.xs[0, 0])
    assert float(xi0.abs()[0]) < 1e-6 and bool(torch.isfinite(mine.xs).all())
    other = "eliminate" if pattern == "output" else "output"
    twin = sqp.solve(ls.wrap_problem(di.make_problem(device="cpu"), defn, other),
                     uniform_grid(0.0, 2.0, 40), T(x0), di.make_params(device="cpu"),
                     device="cpu")
    np.testing.assert_allclose(mine.xs.numpy(), twin.xs.numpy(), atol=2e-2)


# -- the legged loopshaped problem at full width ---------------------------------


def _trot_grids(n, horizon):
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, horizon)
    events, seq = np.asarray(ms.event_times), np.asarray(ms.mode_sequence)
    return make_time_grid(0.0, horizon, n, event_times=events, mode_sequence=seq)


def _flat(lq):
    return {f"{name}.{f}": np.asarray(v) for name, rec in lq._asdict().items() if rec is not None
            for f, v in rec._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def record():
    return chip_smoke.load_record(chip_smoke.LS_RECORD)


@pytest.fixture(scope="module")
def loopshaped_lq(record):
    """The loopshaped legged problem (AL-augmented, the foot constraint kept
    for the projection) on a trot grid of N = 4 over 0.1 s, rk2 with 2
    substeps, at the record's seeded trajectory around the augmented stance,
    against the JAX package's ``approximate_lq`` there (recorded: its
    compile alone takes 23-29 s on the CPU)."""
    n = loopshaping_reference.LQ_N
    tg = _trot_grids(n, loopshaping_reference.LQ_HORIZON)
    np.testing.assert_array_equal(np.asarray(tg.times), record["lq_grid_times"])
    xs, us = loopshaping_reference.lq_trajectory(record["xa0"])
    np.testing.assert_array_equal(xs, record["lq_xs"])
    np.testing.assert_array_equal(us, record["lq_us"])
    tp, _ = lm.make_loopshaping_problem(device="cpu")
    taug = al.augment_problem(tp, project_equalities=True)
    tparams = interface.make_params(tg, device="cpu")
    tdims = tp.constraint_dims(approx.example_params(tparams, "cpu"), device="cpu")
    assert tdims == {"ne": 12, "nse": 0, "ni": 0, "nsi": 0, "nfe": 0}
    talst = al.AlState.init(tdims, n, 10.0, batch=(1,), device="cpu")
    mine = approx.approximate_lq(taug, tg, T(xs), T(us), dict(tparams, al=talst), method="rk2",
                                 substeps=2)
    ref = {k[len("lq_"):]: v for k, v in record.items()
           if k.startswith("lq_") and "." in k}
    return _flat(mine), ref


LOOPSHAPED_LEAVES = [
    "cost.f", "cost.dfdx", "cost.dfdu", "cost.dfdxx", "cost.dfdux", "cost.dfduu",
    "dynamics.f", "dynamics.dfdx", "dynamics.dfdu", "eq.f", "eq.dfdx", "eq.dfdu",
]


@pytest.mark.parametrize("leaf", LOOPSHAPED_LEAVES)
def test_loopshaped_legged_lq_matches_jax(loopshaped_lq, leaf):
    mine, ref = loopshaped_lq
    assert set(mine) == set(ref) == set(LOOPSHAPED_LEAVES)
    assert mine[leaf].dtype == np.float32 and mine[leaf].shape == ref[leaf].shape
    if leaf.startswith("dynamics.dfd") or leaf.startswith("cost.dfdx"):
        assert mine[leaf].shape[-1 if leaf != "dynamics.dfdu" else -2] == 48
    np.testing.assert_allclose(mine[leaf], ref[leaf], rtol=LQ_RTOL,
                               atol=LQ_ATOL * max(1.0, float(np.abs(ref[leaf]).max())))


@pytest.fixture(scope="module")
def trot():
    """The port's inputs of the loopshaped trot (the JAX test's trot_setup)."""
    problem, defn = lm.make_loopshaping_problem(device="cpu")
    grid = _trot_grids(chip_smoke.LS_N, chip_smoke.LS_HORIZON)
    x0 = model.default_state("cpu")
    xa0 = lm.augment_state(defn, x0, model.weight_compensating_input(np.ones(4), "cpu"))
    xs_init, us_init = lm.loopshaped_warm_start(defn, grid, x0)
    return problem, defn, grid, interface.make_params(grid, device="cpu"), xa0, xs_init, us_init


def test_trot_inputs_match_the_record(trot, record):
    _, _, grid, _, xa0, xs_init, us_init = trot
    np.testing.assert_array_equal(np.asarray(grid.times), record["grid_times"])
    np.testing.assert_array_equal(np.asarray(grid.modes), record["grid_modes"])
    np.testing.assert_allclose(xa0.numpy(), record["xa0"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xs_init.numpy(), record["xs_init"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(us_init.numpy(), record["us_init"], rtol=1e-6, atol=1e-6)


def test_loopshaped_trot_three_iterations_match_the_record(trot, record):
    """The legged trot solve at 3 iterations against the JAX package's (the
    card runs the 12-iteration solve).  With a float32 eigh the solution is
    decided by rounding (the eigh of a stage Hessian with a zero block), so
    both packages' Hessian corrections run their eigh in float64 here
    (``chip_smoke.eigh_in_float64``, the record's ``Eigh64`` routes, which
    agree within 1.5e-4), and the solve is held as the card holds it
    (``chip_smoke.hold_eigh64_trot``: iterations equal, xs and us within
    1e-3 + 1e-4 |value|); the dynamics violation, the base height and the
    shaping functional as the JAX test and the record give them."""
    problem, defn, grid, params, xa0, xs_init, us_init = trot
    eigh = torch.linalg.eigh
    with chip_smoke.eigh_in_float64(torch):
        sol = sqp.solve(problem, grid, xa0, params, xs_init=xs_init, us_init=us_init,
                        settings=lm.make_solver_settings(max_iterations=3), device="cpu")
    assert torch.linalg.eigh is eigh
    held = chip_smoke.hold_eigh64_trot(torch, sol, record)
    assert max(held.values()) <= chip_smoke.SOLVE_ATOL
    assert float(sol.performance.dynamics_violation_sse[0]) < chip_smoke.LS_DYN_SSE
    xs_p, us_p = lm.plant_trajectory(defn, sol.xs[0], sol.us[0])
    assert us_p.shape == (chip_smoke.LS_N, 24) and xs_p.shape == (chip_smoke.LS_N + 1, 24)
    assert float((xs_p[:, 8] - model.STAND_HEIGHT).abs().max()) < chip_smoke.LS_HEIGHT_TOL
    p_diag, g_diag = -np.diag(defn.A.numpy()), np.diag(defn.D.numpy())
    dt = float(grid.times[1] - grid.times[0])
    mine = chip_smoke.shaping_functional(us_p.numpy(), p_diag, g_diag, dt, record["u0"])
    np.testing.assert_allclose(mine, float(record["trot3_shaping_functional"]), rtol=1e-2)


def test_loopshaped_closed_loop_first_tick_matches_the_record(record):
    """The dummy MRT loop's first tick (0.08 s: 4 control steps at 50 Hz)
    in the port's Mpc, held as the card holds its loop
    (``chip_smoke.hold_loop_first_tick``: the first tick, which starts where
    the record's does, by iterations and merit), the JAX test's height and
    attitude bounds, and, the Hessian correction's eigh run in float64 here
    (``chip_smoke.eigh_in_float64``), the states against the JAX package's
    loop with its eigh in float64, whose routes agree within 1e-3 over these
    steps (``hold_loop_eigh64_window``); with a float32 eigh the rounding of
    the stage Hessians' zero block decides them on the CPU."""
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop

    problem, defn = lm.make_loopshaping_problem(device="cpu")
    gs = GaitSchedule(trot_gait(0.7))
    grid0 = _trot_grids(chip_smoke.LS_LOOP_N, chip_smoke.LS_LOOP_HORIZON)
    mpc = Mpc(problem, interface.make_params(grid0, device="cpu"),
              MpcSettings(time_horizon=chip_smoke.LS_LOOP_HORIZON,
                          num_intervals=chip_smoke.LS_LOOP_N, solver="sqp"),
              solver_settings=lm.make_solver_settings(
                  max_iterations=chip_smoke.LS_LOOP_MAX_ITERATIONS),
              reference_manager=interface.SwitchedModelReferenceManager(gs, device="cpu"),
              device="cpu")
    its, merits = [], []

    def observe(t, x, u):
        if mpc.solve_timer.count > len(its):
            its.append(int(mpc.last_solution.iterations[0]))
            merits.append(float(mpc.last_solution.performance.merit[0]))

    xa0 = lm.augment_state(defn, model.default_state("cpu"),
                           model.weight_compensating_input(np.ones(4), "cpu"))
    with chip_smoke.eigh_in_float64(torch):
        _, states, _ = dummy_loop(MpcMrtInterface(mpc), xa0, duration=0.08,
                                  mrt_frequency=chip_smoke.LS_MRT_HZ,
                                  mpc_frequency=chip_smoke.LS_MPC_HZ, observers=[observe])
    assert states.shape == (5, 48) and len(its) == 1
    ticks = [{"iterations": i, "merit": m} for i, m in zip(its, merits)]
    held = chip_smoke.hold_loop_first_tick(ticks, record)
    assert held["first_tick"]["iterations"] == its[0]
    window = chip_smoke.hold_loop_eigh64_window(ticks, states.numpy(), record)
    assert window["eigh64_window_steps"] >= states.shape[0]
    assert float((states[:, 8] - model.STAND_HEIGHT).abs().max()) < chip_smoke.LS_LOOP_HEIGHT_TOL
    assert float(states[:, 9:12].abs().max()) < chip_smoke.LS_LOOP_ATTITUDE_TOL

