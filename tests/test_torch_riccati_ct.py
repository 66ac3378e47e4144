"""The continuous-time Riccati sweep (SLQ) of the port vs the JAX package, on
the CPU, and the LQ data it runs on.

The CUDA kernel (``csrc/riccati_ct_backward.cu``) runs only on a card; held
here are its plain PyTorch version against the JAX sweep under ``vmap`` (per
scenario ``reg``, jump intervals at dt = 0, substeps 4 and 8, NaN placement on
an ``R`` that is not positive definite), the kernel's own arithmetic compiled
for the host (the source with host stand-ins for its few device intrinsics,
each thread of a block a host thread, a group's barrier a barrier of its own
threads), the wrapper's checks and launch geometry with its occupancy model
(which need no card), and ``approximate_lq_ct`` against the JAX package's on
the double integrator, the ballbot and EXP0 (with a jump).

Tolerances: the plain sweep against JAX rtol 2e-4 / atol 1e-5 (float32
reassociation over up to 16 dependent evaluations an interval, the same bound
the discrete sweep is held to); the kernel's host build against the plain
version 1e-5 / 1e-6 (the same operations in another order); the LQ data
rtol 1e-5 / atol 1e-6 (the same derivatives taken by two AD systems).
"""
import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.oc.approx import approximate_lq_ct as japproximate_lq_ct
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.ops import riccati_ct as jct

from ocs2_tpu_torch.models import ballbot, double_integrator as di
from ocs2_tpu_torch.oc.approx import approximate_lq_ct
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.ops import riccati_ct, riccati_ct_cuda
from test_torch_slq import exp0_grid, exp0_params, exp0_problem, jexp0

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
HOST_RTOL, HOST_ATOL = 1e-5, 1e-6
LQ_RTOL, LQ_ATOL = 1e-5, 1e-6
FIELDS = riccati_ct.LqrSolution._fields
REGS = np.float32([0.0, 1e-3, 0.5])


def ct_numpy(batch, n, nx, nu, seed, jumps=()):
    """Random continuous-time LQ data, leaves [B, ...] float32; the grid
    uniform on [0, 1] with a duplicated node (dt = 0) after each interval in
    ``jumps``, which are the jump intervals."""
    rng = np.random.default_rng(seed)
    r = lambda sc, *s: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    ex, eu = np.eye(nx, dtype=np.float32), np.eye(nu, dtype=np.float32)
    wq, wr, wj = r(0.1, batch, n + 1, nx, nx), r(0.05, batch, n + 1, nu, nu), r(0.1, batch, n, nx, nx)
    t = list(np.linspace(0.0, 1.0, n + 1 - len(jumps)).astype(np.float32))
    for j in sorted(jumps):
        t.insert(j + 1, t[j])
    is_jump = np.zeros(n, np.float32)
    is_jump[list(jumps)] = 1.0
    return dict(
        A=r(0.5, batch, n + 1, nx, nx), B=r(0.5, batch, n + 1, nx, nu),
        Q=ex + wq + wq.transpose(0, 1, 3, 2), q=r(0.3, batch, n + 1, nx),
        R=eu + wr + wr.transpose(0, 1, 3, 2), r=r(0.3, batch, n + 1, nu),
        P=r(0.1, batch, n + 1, nu, nx), A_jump=ex + r(0.2, batch, n, nx, nx),
        Q_jump=ex + 0.5 * (wj + wj.transpose(0, 1, 3, 2)), q_jump=r(0.2, batch, n, nx),
        Qf=np.broadcast_to(ex, (batch, nx, nx)).copy(), qf=r(0.3, batch, nx),
        times=np.asarray(t, np.float32), is_jump=is_jump,
    )


def torch_coeffs(leaves):
    return riccati_ct.CtLqCoeffs(**{k: torch.as_tensor(np.ascontiguousarray(v))
                                    for k, v in leaves.items()})


def jax_sweep(leaves, regs, substeps):
    axes = jct.CtLqCoeffs(*([0] * 12 + [None, None]))
    fn = jax.jit(jax.vmap(lambda c, rg: jct.slq_backward(c, rg, substeps), in_axes=(axes, 0)))
    return fn(jct.CtLqCoeffs(**{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.asarray(regs))


@pytest.fixture(scope="module", params=[4, 8], ids=lambda s: f"substeps{s}")
def sweep_case(request):
    leaves = ct_numpy(3, 12, 4, 2, seed=0, jumps=(3, 8))
    mine = riccati_ct.slq_backward(torch_coeffs(leaves), torch.as_tensor(REGS), request.param)
    return mine, jax_sweep(leaves, REGS, request.param)


@pytest.mark.parametrize("field", FIELDS)
def test_plain_sweep_matches_jax(sweep_case, field):
    mine, ref = sweep_case
    a, b = getattr(mine, field).numpy(), np.asarray(getattr(ref, field))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_fixture_has_jumps_at_zero_length_intervals():
    leaves = ct_numpy(3, 12, 4, 2, seed=0, jumps=(3, 8))
    dts = np.diff(leaves["times"])
    np.testing.assert_array_equal(dts[leaves["is_jump"] > 0], 0.0)
    assert (dts[leaves["is_jump"] == 0] > 0).all()


def test_plain_sweep_places_nan_as_jax():
    """R = -I at node 4 of scenario 1: the strict Cholesky fails there, in the
    RK4 steps of intervals 3 and 4 (which reach theta at node 4) and in node
    4's gains, and NaN reaches every earlier node of that scenario and its dv1,
    dv2; the other scenarios are untouched."""
    leaves = ct_numpy(3, 8, 3, 2, seed=1, jumps=(2,))
    leaves["R"][1, 4] = -np.eye(2, dtype=np.float32)
    mine = riccati_ct.slq_backward(torch_coeffs(leaves), torch.as_tensor(REGS), 4)
    ref = jax_sweep(leaves, REGS, 4)
    for f in FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)], rtol=RTOL, atol=ATOL)
    nan_nodes = np.isnan(mine.gains.numpy()).all(axis=(2, 3))
    np.testing.assert_array_equal(nan_nodes[1], np.arange(8) <= 4)
    assert not nan_nodes[[0, 2]].any() and np.isnan(mine.dv1[1].item())


def test_scalar_reg_equals_a_constant_batch():
    leaves = ct_numpy(2, 5, 3, 1, seed=2)
    c = torch_coeffs(leaves)
    a = riccati_ct.slq_backward(c, 0.1, 4)
    b = riccati_ct.slq_backward(c, torch.full((2,), 0.1), 4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = torch_coeffs(ct_numpy(2, 5, 3, 2, seed=3, jumps=(1,)))
    before = riccati_ct_cuda.launch_count
    a = riccati_ct.slq_backward(c, torch.zeros(2), 4)
    b = riccati_ct._slq_backward_plain(c, torch.zeros(2), 4)
    forced = riccati_ct.slq_backward(c, torch.zeros(2), 4, force_plain=True)
    assert riccati_ct_cuda.launch_count == before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
        np.testing.assert_array_equal(getattr(forced, f).numpy(), getattr(b, f).numpy())
    assert a.gains.shape == (2, 5, 2, 3) and a.value_S.shape == (2, 6, 3, 3)
    assert a.dv1.shape == (2,)


def test_kernel_request_on_cpu_tensors_raises_and_does_not_fall_back():
    c = torch_coeffs(ct_numpy(2, 4, 3, 2, seed=4))
    before = riccati_ct_cuda.launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati_ct_cuda.slq_backward_cuda(c, torch.zeros(2), 4)
    assert riccati_ct_cuda.launch_count == before


@pytest.mark.parametrize("breakage, exc, match", [
    ("float64", TypeError, "float32"),
    ("noncontiguous", ValueError, "contiguous"),
    ("shape", ValueError, "must be"),
    ("reg", ValueError, "reg must be"),
    ("substeps", ValueError, "substeps"),
    ("wide", ValueError, "nx, nu <="),
])
def test_wrapper_refuses_bad_inputs_without_a_card(breakage, exc, match):
    leaves = ct_numpy(2, 4, 3, 2, seed=5)
    reg, substeps = torch.zeros(2), 4
    if breakage == "wide":
        leaves = ct_numpy(1, 2, 33, 1, seed=5)
        reg = torch.zeros(1)
    c = torch_coeffs(leaves)
    if breakage == "float64":
        c = c._replace(Q=c.Q.double())
    elif breakage == "noncontiguous":
        c = c._replace(A=c.A.transpose(-1, -2))
    elif breakage == "shape":
        c = c._replace(is_jump=c.is_jump[:-1].contiguous())
    elif breakage == "reg":
        reg = torch.zeros(3)
    elif breakage == "substeps":
        substeps = 0
    with pytest.raises(exc, match=match):
        riccati_ct_cuda.check_inputs(c, reg, substeps)


def test_wrapper_accepts_checked_inputs_and_reports_dims():
    c = torch_coeffs(ct_numpy(5, 7, 3, 2, seed=6, jumps=(2,)))
    assert riccati_ct_cuda.check_inputs(c, torch.zeros(5), 4) == (5, 7, 3, 2)
    assert riccati_ct_cuda.check_inputs(c, 0.0, 8) == (5, 7, 3, 2)


@pytest.mark.parametrize("shape", [(10, 3, 4096), (2, 1, 1), (3, 5, 77), (24, 12, 256)])
def test_launch_geometry_fits_the_card(shape):
    """The CPU-side occupancy model: whole warps a block within the block's
    limits, and the SLQ lane's batch resident at once on 132 SMs."""
    nx, nu, batch = shape
    g = riccati_ct_cuda.launch_geometry(nx, nu, batch)
    group = riccati_ct_cuda.threads_per_scenario(nx, nu)
    assert g.blocks * g.scenarios_per_block >= batch > (g.blocks - 1) * g.scenarios_per_block
    assert g.threads == group * g.scenarios_per_block <= riccati_ct_cuda.MAX_BLOCK_THREADS
    assert g.threads % 32 == 0
    per = riccati_ct_cuda.shared_bytes_per_scenario(nx, nu)
    assert g.shared_bytes == g.scenarios_per_block * per
    assert g.shared_bytes <= riccati_ct_cuda.MAX_SHARED_BYTES
    assert g.blocks_per_sm == riccati_ct_cuda.modelled_blocks_per_sm(nx, nu, g.scenarios_per_block)
    assert g.waves == -(-g.blocks // (riccati_ct_cuda.NUM_SMS * g.blocks_per_sm)) == 1
    if batch == 4096:  # two scenarios a warp, 16 warps an SM
        assert (group, g.scenarios_per_block, g.blocks_per_sm) == (16, 2, 16)
        assert riccati_ct_cuda.shared_bytes_per_scenario(nx, nu) <= 6 * 1024


@pytest.mark.parametrize("resident, want_spb, want_waves", [
    (lambda spb: 16, 2, 1),        # the model's answer at (10, 3)
    (lambda spb: 8, 4, 1),         # half the blocks fit: twice the scenarios a block
    (lambda spb: 0 if spb < 6 else 2, 16, 1),  # small blocks refused: the smallest that fit
    (lambda spb: 1, 16, 2),        # one block an SM: the largest blocks, fewest waves
], ids=["model", "half", "small_refused", "one_block"])
def test_launch_geometry_follows_the_occupancy_probe(resident, want_spb, want_waves):
    """On the card the library's probe answers for each block size: the rule
    takes the fewest waves, then the smallest block."""
    g = riccati_ct_cuda.launch_geometry(10, 3, 4096, blocks_per_sm=resident)
    assert (g.scenarios_per_block, g.waves) == (want_spb, want_waves)
    assert g.blocks_per_sm == resident(want_spb)


def test_library_name_depends_on_pair_and_source():
    from ocs2_tpu_torch.ops import _build

    a = _build.library_path(riccati_ct_cuda.SOURCE, riccati_ct_cuda._defines(10, 3))
    b = _build.library_path(riccati_ct_cuda.SOURCE, riccati_ct_cuda._defines(2, 1))
    assert a != b and "riccati_ct_backward" in a.name and "nx10_nu3" in a.name


# -- the kernel's arithmetic, compiled for the host ------------------------------

_HOST_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
struct Dim3 { unsigned x = 0; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
extern thread_local Dim3 threadIdx, blockIdx;
extern thread_local std::barrier<>* t_group_barrier;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
"""

# Host stand-ins for the kernel's device intrinsics: a group's barrier is a
# barrier of its own threads (on the card the groups of a warp meet on one), a
# copy lands at once.
_HOST_INTRINSICS = r"""
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float quiet_nan() { return __int_as_float(0x7fc00000); }
inline float pivot_sqrt(float s) { return std::sqrt(s); }
inline float pivot_reciprocal(float d) { return 1.0f / d; }
inline void group_sync() { t_group_barrier->arrive_and_wait(); }
inline void copy4(float* dst, const float* src) { *dst = *src; }
inline void copy_wait_all() {}
"""

_HOST_MAIN = r"""
#include "cuda_runtime.h"
#include <memory>
#include <thread>
#include <vector>
thread_local Dim3 threadIdx, blockIdx;
thread_local std::barrier<>* t_group_barrier;
static float smem_block[232448 / 4];
#include "kernel_body.inc"
extern "C" int host_shared_bytes() { return kScenarioBytes; }
extern "C" int host_threads_per_scenario() { return G; }
extern "C" void host_run(const float* A, const float* Bm, const float* Q, const float* q,
    const float* R, const float* r, const float* P, const float* AJ, const float* QJ,
    const float* qJ, const float* Qf, const float* qf, const float* times,
    const float* is_jump, const float* reg, float* gains, float* kff, float* vS, float* vs,
    float* dv1, float* dv2, int batch, int n, int spb, int substeps) {
  for (int bk = 0; bk < (batch + spb - 1) / spb; ++bk) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int w = 0; w < spb; ++w) bars.emplace_back(new std::barrier<>(G));
    std::vector<std::thread> lanes;
    for (int t = 0; t < spb * G; ++t) {
      std::barrier<>* bar = bars[t / G].get();
      lanes.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = bk;
        t_group_barrier = bar;
        riccati_ct_backward_kernel(Params{A, Bm, Q, q, R, r, P, AJ, QJ, qJ, Qf, qf, times,
                                          is_jump, reg, gains, kff, vS, vs, dv1, dv2, batch, n,
                                          spb, substeps});
      });
    }
    for (auto& lane : lanes) lane.join();
  }
}
"""


def _host_kernel(tmp_path, nx, nu):
    """The kernel's source up to its host interface, with host stand-ins for
    its device intrinsics and the block's shared memory a static array, built
    by g++ as a library: each thread of a block a host thread, a group's
    barrier a barrier of its own threads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = (riccati_ct_cuda._build.CSRC_DIR / riccati_ct_cuda.SOURCE).read_text()
    body = src.split("// -- host interface")[0]
    body = re.sub(r"// -- device intrinsics.*?// -- end of device intrinsics[^\n]*\n",
                  lambda _: _HOST_INTRINSICS, body, count=1, flags=re.S)
    body = body.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    body = body.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = smem_block;")
    (tmp_path / "cuda_runtime.h").write_text(_HOST_RUNTIME)
    (tmp_path / "kernel_body.inc").write_text(body)
    (tmp_path / "host_main.cpp").write_text(_HOST_MAIN)
    out = tmp_path / f"libhost_{nx}_{nu}.so"
    built = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC",
         f"-I{tmp_path}", f"-DNX={nx}",
         f"-DNU={nu}", "-o", str(out), str(tmp_path / "host_main.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    lib.host_run.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4
    return lib


@pytest.mark.parametrize("case", ["jumps_b9", "nu_gt_nx_nan", "ballbot_b9_ragged",
                                  "odd_edges_b5", "one_thread_b9", "cartpole_b9"])
def test_kernel_source_on_the_host_matches_the_plain_version(tmp_path, case):
    """The kernel's phases, barriers and layout, run on the host: equal to
    the plain version at its tolerance, with NaN where the plain version has
    it (R = -I at node 4 of scenario 1 in the second case), and the layout's
    bytes and the group's threads equal to the wrapper's.  The cases cover the
    kernel's three shapes of work: single-entry tiles ((4, 2), (3, 5)); 2 x 2
    tiles at the ballbot's (10, 3) with two scenarios a block and an odd
    batch, so the last block's second group leaves at once while its partner
    runs on, and at (5, 2), whose tiles cross the matrix's edge; and one
    thread a scenario at (2, 1), 32 scenarios a block.  The last case is the
    cartpole swing-up's (4, 1): 8 threads a scenario with single-entry
    tiles, no jump."""
    if case == "jumps_b9":
        nx, nu, batch, n, jumps, substeps = 4, 2, 9, 10, (3, 7), 4
    elif case == "nu_gt_nx_nan":
        nx, nu, batch, n, jumps, substeps = 3, 5, 3, 6, (2,), 8
    elif case == "ballbot_b9_ragged":
        nx, nu, batch, n, jumps, substeps = 10, 3, 9, 6, (4,), 4
    elif case == "odd_edges_b5":
        nx, nu, batch, n, jumps, substeps = 5, 2, 5, 6, (1, 4), 4
    elif case == "one_thread_b9":
        nx, nu, batch, n, jumps, substeps = 2, 1, 9, 12, (3, 8), 4
    else:
        nx, nu, batch, n, jumps, substeps = 4, 1, 9, 10, (), 4
    lib = _host_kernel(tmp_path, nx, nu)
    assert lib.host_shared_bytes() == riccati_ct_cuda.shared_bytes_per_scenario(nx, nu)
    assert lib.host_threads_per_scenario() == riccati_ct_cuda.threads_per_scenario(nx, nu)
    leaves = ct_numpy(batch, n, nx, nu, seed=7, jumps=jumps)
    if case == "nu_gt_nx_nan":
        leaves["R"][1, 4] = -np.eye(nu, dtype=np.float32)
    c = torch_coeffs(leaves)
    reg = torch.as_tensor(np.resize(np.float32([0.0, 1e-6, 0.1, 2.0]), batch))
    spb = riccati_ct_cuda.launch_geometry(nx, nu, batch).scenarios_per_block
    if case == "ballbot_b9_ragged":
        assert spb == 2 and batch % spb == 1
    if case == "one_thread_b9":
        assert riccati_ct_cuda.threads_per_scenario(nx, nu) == 1 and spb == 32
    if case == "cartpole_b9":
        assert riccati_ct_cuda.threads_per_scenario(nx, nu) == 8
    out = riccati_ct.LqrSolution(
        torch.full((batch, n, nu, nx), 7.0), torch.full((batch, n, nu), 7.0),
        torch.full((batch, n + 1, nx, nx), 7.0), torch.full((batch, n + 1, nx), 7.0),
        torch.full((batch,), 7.0), torch.full((batch,), 7.0))
    lib.host_run(*(t.data_ptr() for t in (*c, reg, *out)), batch, n, spb, substeps)
    ref = riccati_ct._slq_backward_plain(c, reg, substeps)
    for f in FIELDS:
        a, b = getattr(out, f).numpy(), getattr(ref, f).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)], rtol=HOST_RTOL,
                                   atol=HOST_ATOL, err_msg=f)
    assert np.isnan(ref.gains.numpy()).any() == (case == "nu_gt_nx_nan")


# -- approximate_lq_ct --------------------------------------------------------------

CT_FIELDS = riccati_ct.CtLqCoeffs._fields


def _lq_case(name):
    """(port coeffs, JAX coeffs) of one problem, inputs from a numpy seed."""
    rng = np.random.default_rng(8)
    if name == "double_integrator":
        n, batch, nx, nu = 6, 2, di.NX, di.NU
        mine_p, mine_par, grid = di.make_problem(device="cpu"), di.make_params(device="cpu"), uniform_grid(0.0, 1.0, n)
        ref_p, ref_par, jgrid = jdi.make_problem(), jdi.make_params(), juniform_grid(0.0, 1.0, n)
    elif name == "ballbot":
        n, batch, nx, nu = 8, 2, ballbot.NX, ballbot.NU
        mine_p, mine_par, grid = ballbot.make_problem(device="cpu"), ballbot.make_params(device="cpu"), uniform_grid(0.0, 1.0, n)
        ref_p, ref_par, jgrid = jballbot.make_problem(), jballbot.make_params(), juniform_grid(0.0, 1.0, n)
    else:  # EXP0: two linear modes, a jump interval at the switch
        n, batch, nx, nu = 20, 1, 2, 1
        mine_p, mine_par, grid = exp0_problem(), exp0_params(), exp0_grid(n)
        ref_p, ref_par, jgrid = jexp0.exp0_problem(), jexp0.exp0_params(), jexp0.exp0_grid(n)
    xs = (0.5 * rng.standard_normal((batch, n + 1, nx))).astype(np.float32)
    us = (0.5 * rng.standard_normal((batch, n, nu))).astype(np.float32)
    mine = approximate_lq_ct(mine_p, grid, torch.as_tensor(xs), torch.as_tensor(us), mine_par)
    ref = jax.jit(jax.vmap(lambda x, u: japproximate_lq_ct(ref_p, jgrid, x, u, ref_par)))(
        jnp.asarray(xs), jnp.asarray(us))
    return mine, ref


@pytest.fixture(scope="module", params=["double_integrator", "ballbot", "exp0"])
def lq_case(request):
    return request.param, _lq_case(request.param)


@pytest.mark.parametrize("field", CT_FIELDS)
def test_approximate_lq_ct_matches_jax(lq_case, field):
    name, (mine, ref) = lq_case
    a = getattr(mine, field).numpy()
    b = np.asarray(getattr(ref, field))
    if field in ("times", "is_jump"):
        b = b[0]  # shared by the scenarios in the port, mapped in JAX
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=LQ_RTOL, atol=LQ_ATOL)
    assert getattr(mine, field).is_contiguous()


def test_exp0_lq_data_has_its_jump():
    n = 20
    xs = torch.zeros((1, n + 1, 2))
    us = torch.zeros((1, n, 1))
    mine = approximate_lq_ct(exp0_problem(), exp0_grid(n), xs, us, exp0_params())
    k = int(np.argmax(mine.is_jump.numpy()))
    assert mine.is_jump.sum().item() == 1.0 and mine.times[k] == mine.times[k + 1]
    # The mode switches across the jump: A differs on the two sides.
    assert not torch.allclose(mine.A[0, k], mine.A[0, k + 1])
