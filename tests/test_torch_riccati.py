"""Riccati sweeps of the port vs the JAX package, on the CPU.

The CUDA kernel itself runs only on a card; what is held here is its plain
PyTorch version (the arithmetic the kernel repeats) against the JAX batched
path and against the Pallas kernel in interpret mode, its strict-pivot form
against the JAX single-scenario sweep, that sweep including its NaN
behaviour, the forward pass, the wrapper's argument checks (which run before
any build and need no card) and the launch geometry it hands the kernel, at
the existing shapes and at the widest pair, the loopshaped legged problem's
(48, 12).  The kernel's own arithmetic is held too: its source is compiled
for the host by g++ with stand-ins for its few device intrinsics (each
thread of a block a host thread, a group's barrier a barrier of its own
threads, the stage barriers counted as on the card) and run against the
plain version.
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

from ocs2_tpu.ops import riccati as jriccati
from ocs2_tpu.ops.riccati_pallas import lqr_backward_pallas

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.ops import riccati, riccati_cuda

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

# float32 reassociation: the order of the k-accumulation differs.
RTOL, ATOL = 2e-4, 1e-5
FIELDS = riccati.LqrSolution._fields


def _psd(rng, shape_prefix, n, eps):
    m = rng.standard_normal(shape_prefix + (n, n))
    return m @ np.swapaxes(m, -1, -2) / n + eps * np.eye(n)


def lq_numpy(batch, horizon, nx, nu, seed):
    """Random LQ data as numpy float32, leaves [B, N, ...] (the recipe of
    tests/lq_fixtures.py, drawn with numpy so both packages get the same)."""
    rng = np.random.default_rng(seed)
    pre = (batch, horizon)
    leaves = dict(
        A=rng.standard_normal(pre + (nx, nx)) / np.sqrt(nx) + 0.5 * np.eye(nx),
        B=0.5 * rng.standard_normal(pre + (nx, nu)),
        b=0.1 * rng.standard_normal(pre + (nx,)),
        Qxx=_psd(rng, pre, nx, 0.2),
        qx=rng.standard_normal(pre + (nx,)),
        Quu=_psd(rng, pre, nu, 0.5),
        qu=rng.standard_normal(pre + (nu,)),
        Qux=0.05 * rng.standard_normal(pre + (nu, nx)),
        Qf=_psd(rng, (batch,), nx, 0.3),
        qf=rng.standard_normal((batch, nx)),
    )
    return {k: v.astype(np.float32) for k, v in leaves.items()}


def both(leaves):
    return (
        jriccati.LqrCoeffs(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        convert.lqr_coeffs_from_numpy(leaves, device="cpu"),
    )


CASES = {
    "b256_n12_nx5_nu3_regs": (256, 12, 5, 3, np.tile(np.float32([0.0, 1e-6, 0.1, 2.0]), 64)),
    "b512_n6_nx8_nu4": (512, 6, 8, 4, np.full((512,), 1e-6, np.float32)),
    # The loopshaped legged problem's (nx, nu): 24 plant and 24 filter states,
    # the projected 12 inputs; the widest pair the kernel takes.
    "b4_n3_nx48_nu12_regs": (4, 3, 48, 12, np.float32([0.0, 1e-6, 0.1, 2.0])),
}


@pytest.fixture(scope="module", params=list(CASES))
def batched_case(request):
    batch, n, nx, nu, regs = CASES[request.param]
    jc, tc = both(lq_numpy(batch, n, nx, nu, seed=1))
    mine = riccati._lqr_backward_batched(tc, torch.as_tensor(regs))
    ref_xla = jax.jit(jriccati._lqr_backward_batched)(jc, jnp.asarray(regs))
    ref_pallas = lqr_backward_pallas(jc, jnp.asarray(regs), interpret=True)
    return mine, ref_xla, ref_pallas


@pytest.mark.parametrize("field", FIELDS)
def test_plain_version_matches_jax_batched(batched_case, field):
    mine, ref, _ = batched_case
    np.testing.assert_allclose(
        getattr(mine, field).numpy(), np.asarray(getattr(ref, field)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("field", FIELDS)
def test_plain_version_matches_pallas_interpret(batched_case, field):
    mine, _, ref = batched_case
    np.testing.assert_allclose(
        getattr(mine, field).numpy(), np.asarray(getattr(ref, field)),
        rtol=RTOL, atol=ATOL)


def test_lqr_backward_dispatches_to_plain_on_cpu():
    _, tc = both(lq_numpy(4, 5, 3, 2, seed=2))
    before = riccati_cuda.launch_count
    a = riccati.lqr_backward(tc, torch.zeros(4))
    b = riccati._lqr_backward_batched(tc, 0.0)
    assert riccati_cuda.launch_count == before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
    assert a.gains.shape == (4, 5, 2, 3) and a.value_S.shape == (4, 6, 3, 3)
    assert a.dv1.shape == (4,)


def test_pivot_clamp_matches_jax_on_indefinite_quu():
    """The batched form clamps Cholesky pivots at sqrt(max(p, 1e-12)) instead
    of failing: on a scenario with an indefinite Quu it goes on as the JAX
    batched path does (same finite/non-finite pattern), and the other
    scenarios of the batch are untouched."""
    leaves = lq_numpy(8, 4, 3, 2, seed=3)
    leaves["Quu"][2] = -50.0 * np.eye(2, dtype=np.float32)
    jc, tc = both(leaves)
    mine = riccati._lqr_backward_batched(tc, 0.0)
    ref = jriccati._lqr_backward_batched(jc, jnp.zeros(8))
    others = [0, 1, 3, 4, 5, 6, 7]
    for f in FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
        np.testing.assert_allclose(a[others], b[others], rtol=RTOL, atol=ATOL, err_msg=f)
    # The last node is reached with finite values: its clamped pivot shows
    # as a huge gain, not as a failure.
    assert np.isfinite(mine.gains[2, 3].numpy()).all()
    assert np.abs(mine.gains[2].numpy()[np.isfinite(mine.gains[2].numpy())]).max() > 1e3


def _single(leaves, i):
    one = {k: v[i] for k, v in leaves.items()}
    return both(one)


@pytest.mark.parametrize("field", FIELDS)
def test_single_matches_jax(field):
    jc, tc = _single(lq_numpy(2, 10, 6, 3, seed=4), 0)
    mine = riccati._lqr_backward_single(tc, 1e-6)
    ref = jax.jit(jriccati._lqr_backward_single)(jc, jnp.asarray(1e-6))
    np.testing.assert_allclose(
        getattr(mine, field).numpy(), np.asarray(getattr(ref, field)),
        rtol=RTOL, atol=ATOL)


def test_single_nan_placement_on_non_pd_quu():
    """The single-scenario sweep does not clamp: from the node whose Quu_hat
    is not positive definite backwards everything is NaN, as in JAX."""
    leaves = lq_numpy(1, 8, 4, 2, seed=5)
    leaves["Quu"][0, 5] = -100.0 * np.eye(2, dtype=np.float32)
    jc, tc = _single(leaves, 0)
    mine = riccati._lqr_backward_single(tc, 0.0)
    ref = jriccati._lqr_backward_single(jc, jnp.asarray(0.0))
    for f in FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isnan(mine.gains[:6].numpy()).all()
    assert np.isfinite(mine.gains[6:].numpy()).all()


@pytest.mark.parametrize("batched", [False, True])
def test_lqr_forward_matches_jax(batched):
    leaves = lq_numpy(3, 7, 5, 2, seed=6)
    rng = np.random.default_rng(7)
    dx0 = rng.standard_normal((3, 5)).astype(np.float32)
    jc, tc = both(leaves)
    jsol = jriccati._lqr_backward_batched(jc, jnp.zeros(3))
    tsol = convert.lqr_solution_from_numpy(
        jax.tree.map(np.asarray, jsol)._asdict(), device="cpu")
    jdxs, jdus = jax.vmap(jriccati.lqr_forward)(jc, jsol, jnp.asarray(dx0))
    if batched:
        dxs, dus = riccati.lqr_forward(tc, tsol, torch.as_tensor(dx0))
    else:
        pick = lambda rec, i: type(rec)(*(leaf[i] for leaf in rec))  # noqa: E731
        outs = [riccati.lqr_forward(pick(tc, i), pick(tsol, i), torch.as_tensor(dx0[i]))
                for i in range(3)]
        dxs = torch.stack([o[0] for o in outs])
        dus = torch.stack([o[1] for o in outs])
    np.testing.assert_allclose(dxs.numpy(), np.asarray(jdxs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dus.numpy(), np.asarray(jdus), rtol=1e-4, atol=1e-5)


def _good():
    return convert.lqr_coeffs_from_numpy(lq_numpy(4, 3, 5, 2, seed=8), device="cpu")


def test_cuda_wrapper_accepts_checked_inputs_and_reports_dims():
    assert riccati_cuda.check_inputs(_good(), torch.zeros(4)) == (4, 3, 5, 2)
    assert riccati_cuda.check_inputs(_good(), 0.1) == (4, 3, 5, 2)


@pytest.mark.parametrize("breakage, exc, match", [
    (lambda c: c._replace(A=c.A.double()), TypeError, "float32"),
    (lambda c: c._replace(Qxx=c.Qxx.transpose(-1, -2)), ValueError, "contiguous"),
    (lambda c: c._replace(Qux=c.Qux[:, :, :, :4].contiguous()), ValueError, "Qux"),
    (lambda c: c._replace(b=c.b[0]), ValueError, "dims"),
    (lambda c: convert.lqr_coeffs_from_numpy(lq_numpy(2, 2, 49, 2, seed=9), device="cpu"),
     ValueError, "nx, nu <= 48"),
    (lambda c: convert.lqr_coeffs_from_numpy(lq_numpy(2, 2, 4, 49, seed=9), device="cpu"),
     ValueError, "nx, nu <= 48"),
])
def test_cuda_wrapper_refuses_bad_inputs_without_a_card(breakage, exc, match):
    before = riccati_cuda.launch_count
    with pytest.raises(exc, match=match):
        riccati_cuda.lqr_backward_cuda(breakage(_good()), torch.zeros(4))
    assert riccati_cuda.launch_count == before


def test_cuda_wrapper_refuses_bad_reg_and_cpu_tensors():
    with pytest.raises(ValueError, match="reg"):
        riccati_cuda.lqr_backward_cuda(_good(), torch.zeros(3))
    with pytest.raises(TypeError, match="reg"):
        riccati_cuda.lqr_backward_cuda(_good(), torch.zeros(4, dtype=torch.float64))
    # No fallback: a CPU tensor is refused, not sent to the plain version.
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati_cuda.lqr_backward_cuda(_good(), torch.zeros(4))


def test_library_name_depends_on_pair_and_source():
    from ocs2_tpu_torch.ops import _build

    a = _build.library_path(riccati_cuda.SOURCE, riccati_cuda._defines(10, 3))
    b = _build.library_path(riccati_cuda.SOURCE, riccati_cuda._defines(12, 4))
    assert a != b and a.parent == _build.BUILD_DIR
    assert "nx10" in a.name and "nu3" in a.name and a.suffix == ".so"


def test_lqr_backward_takes_the_single_scenario_route_for_a_batch_of_one():
    """B = 1 is the un-vmapped solve of the reference: no pivot clamp, NaN
    from the node whose Quu_hat is not positive definite, placed as in JAX;
    the plain version on the same data clamps and stays finite there."""
    leaves = lq_numpy(1, 8, 4, 2, seed=5)
    leaves["Quu"][0, 5] = -100.0 * np.eye(2, dtype=np.float32)
    jc, _ = _single(leaves, 0)
    _, tc = both(leaves)
    before = riccati_cuda.launch_count
    mine = riccati.lqr_backward(tc, torch.zeros(1))
    assert riccati_cuda.launch_count == before
    ref = jriccati.lqr_backward(jc, 0.0)
    for f in FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == (1,) + b.shape, f
        np.testing.assert_array_equal(np.isnan(a[0]), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a[0], b, rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isnan(mine.gains[0, :6].numpy()).all() and np.isfinite(mine.gains[0, 6:].numpy()).all()
    clamped = riccati.lqr_backward(tc, torch.zeros(1), force_plain=True)
    assert np.isfinite(clamped.gains[0, 5].numpy()).all()


@pytest.mark.parametrize("reg", [1e-6, torch.full((1,), 0.3)])
def test_batch_of_one_matches_jax_single(reg):
    leaves = lq_numpy(1, 10, 6, 3, seed=4)
    jc, _ = _single(leaves, 0)
    _, tc = both(leaves)
    mine = riccati.lqr_backward(tc, reg)
    ref = jax.jit(jriccati.lqr_backward)(jc, jnp.asarray(float(np.asarray(reg).reshape(-1)[0])))
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(mine, f).numpy()[0], np.asarray(getattr(ref, f)), rtol=RTOL, atol=ATOL,
            err_msg=f)


# -- strict pivots: the plain version of the kernel's B = 1 route ---------------


@pytest.fixture(scope="module", params=[1, 3])
def strict_case(request):
    batch = request.param
    leaves = lq_numpy(batch, 10, 6, 3, seed=40 + batch)
    regs = np.float32([1e-6, 0.1, 0.0])[:batch]
    _, tc = both(leaves)
    mine = riccati._lqr_backward_batched(tc, torch.as_tensor(regs), strict=True)
    single = jax.jit(jriccati._lqr_backward_single)
    refs = [single(_single(leaves, i)[0], jnp.asarray(regs[i])) for i in range(batch)]
    return mine, refs


@pytest.mark.parametrize("field", FIELDS)
def test_strict_plain_version_matches_jax_single(strict_case, field):
    """On positive-definite data strict pivots change nothing: per scenario
    the entry-form sweep is the reference's un-vmapped one (float32
    reassociation)."""
    mine, refs = strict_case
    for i, ref in enumerate(refs):
        np.testing.assert_allclose(
            getattr(mine, field).numpy()[i], np.asarray(getattr(ref, field)),
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_strict_plain_version_places_nan_as_jax_single(batch):
    """A Quu that is not positive definite at one node of one scenario: NaN in
    K, kff, S, s of that node and every earlier one and in dv1, dv2 of that
    scenario, element for element as in the JAX single-scenario sweep; the
    other scenarios stay finite."""
    leaves = lq_numpy(batch, 8, 4, 2, seed=5)
    leaves["Quu"][batch - 1, 5] = -100.0 * np.eye(2, dtype=np.float32)
    _, tc = both(leaves)
    mine = riccati._lqr_backward_batched(tc, 0.0, strict=True)
    for i in range(batch):
        ref = jriccati._lqr_backward_single(_single(leaves, i)[0], jnp.asarray(0.0))
        for f in FIELDS:
            a, b = getattr(mine, f).numpy()[i], np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isnan(mine.gains[batch - 1, :6].numpy()).all()
    assert np.isfinite(mine.gains[batch - 1, 6:].numpy()).all()
    assert np.isnan(mine.dv1[batch - 1].numpy()) and np.isnan(mine.dv2[batch - 1].numpy())
    assert np.isfinite(mine.gains[:batch - 1].numpy()).all()
    clamped = riccati._lqr_backward_batched(tc, 0.0)
    assert np.isfinite(clamped.gains[batch - 1, 5].numpy()).all()


def test_lqr_backward_hooks_on_cpu_tensors():
    """On CPU tensors nothing is launched: a batch of one takes the
    single-scenario sweep with or without force_single, which refuses a
    larger batch; force_plain takes the clamped plain version."""
    _, tc = both(lq_numpy(1, 6, 4, 2, seed=12))
    before = riccati_cuda.launch_count
    a = riccati.lqr_backward(tc, 1e-6)
    b = riccati.lqr_backward(tc, 1e-6, force_single=True)
    c = riccati.lqr_backward(tc, 1e-6, force_plain=True)
    assert riccati_cuda.launch_count == before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
        np.testing.assert_allclose(
            getattr(a, f).numpy(), getattr(c, f).numpy(), rtol=RTOL, atol=ATOL)
    _, two = both(lq_numpy(2, 6, 4, 2, seed=12))
    with pytest.raises(ValueError, match="batch of one"):
        riccati.lqr_backward(two, 1e-6, force_single=True)


# -- launch geometry of the CUDA kernel (plain Python, no card) -----------------

import chip_smoke  # noqa: E402

GEOMETRY_SHAPES = chip_smoke.KERNEL_SHAPES + [
    chip_smoke.STRICT_SHAPE, (32, 32, 1, 100), (32, 32, 256, 100), (32, 32, 4096, 100),
    (24, 12, 4096, 100), (1, 1, 1, 1),
]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_geometry_fits_the_card(shape):
    nx, nu, batch, _ = shape
    g = riccati_cuda.launch_geometry(nx, nu, batch)
    group = riccati_cuda.threads_per_scenario(nx, nu)
    assert group % 32 == 0 and 32 <= group <= riccati_cuda.MAX_BLOCK_THREADS
    assert g.threads == g.scenarios_per_block * group
    assert g.threads <= riccati_cuda.MAX_BLOCK_THREADS <= 1024
    assert g.shared_bytes == g.scenarios_per_block * riccati_cuda.shared_bytes_per_scenario(nx, nu)
    assert g.shared_bytes <= 232448
    # Every scenario has a group, and no block is empty.
    assert g.blocks * g.scenarios_per_block >= batch > (g.blocks - 1) * g.scenarios_per_block
    # A group wider than a warp meets on a named barrier of its own (1 ... 15).
    assert group == 32 or g.scenarios_per_block <= 15
    # A small batch spreads over the card before blocks take several scenarios.
    assert g.blocks >= min(batch, riccati_cuda.NUM_SMS - 4)


def test_launch_geometry_at_the_main_paths_shapes():
    legged = riccati_cuda.launch_geometry(24, 12, 256)
    assert legged.blocks >= 128 and legged.scenarios_per_block == 1
    tick = riccati_cuda.launch_geometry(24, 12, 1)
    assert (tick.blocks, tick.threads) == (1, riccati_cuda.threads_per_scenario(24, 12))
    ballbot = riccati_cuda.launch_geometry(10, 3, 4096)
    resident_blocks = min(
        -(-ballbot.blocks // riccati_cuda.NUM_SMS), 232448 // ballbot.shared_bytes)
    assert resident_blocks * ballbot.threads // 32 >= 16  # warps resident on an SM
    with pytest.raises(ValueError, match="no launch geometry"):
        riccati_cuda.launch_geometry(200, 200, 4)


@pytest.mark.parametrize("pair, odd", [
    ((24, 12), ()), ((12, 4), ()), ((10, 3), ("B", "b", "qx", "Quu", "qu", "Qux")),
    ((3, 5), ("A", "B", "b", "Qxx", "qx", "Quu", "qu", "Qux")),
])
def test_copy_width_is_chosen_per_leaf(pair, odd):
    """16-byte bulk copies where a leaf's per-node run is a multiple of 16
    bytes, 4-byte copies for the others."""
    widths = riccati_cuda.copy_widths(*pair)
    floats = riccati_cuda.stage_leaf_floats(*pair)
    assert tuple(widths) == riccati_cuda.STAGE_LEAVES
    for name in riccati_cuda.STAGE_LEAVES:
        assert widths[name] == (4 if name in odd else 16), name
        assert (4 * floats[name]) % widths[name] == 0


def test_cuda_wrapper_refuses_a_misaligned_bulk_leaf_only_on_the_card():
    """The alignment of a leaf is checked after the device: a CPU tensor is
    refused as such, whatever its alignment."""
    good = _good()
    flat = torch.zeros(good.A.numel() + 1)
    shifted = good._replace(A=flat[1:].view_as(good.A).copy_(good.A))
    assert shifted.A.is_contiguous() and shifted.A.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati_cuda.lqr_backward_cuda(shifted, torch.zeros(4))


def _indefinite_lq(seed):
    """LQ data whose joint stage Hessians and Qf are indefinite."""
    leaves = lq_numpy(3, 5, 4, 2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in ("Qxx", "Quu", "Qf"):
        w = rng.standard_normal(leaves[k].shape).astype(np.float32)
        leaves[k] = leaves[k] - 0.8 * (w + np.swapaxes(w, -1, -2))
    leaves["Qux"] = 3.0 * leaves["Qux"]
    return leaves


@pytest.mark.parametrize("method", ["eigh", "gershgorin"])
@pytest.mark.parametrize("field", ["Qxx", "Qux", "Quu", "Qf"])
def test_convexify_matches_jax(method, field):
    leaves = _indefinite_lq(seed=31)
    jc, tc = both(leaves)
    ref = jax.vmap(lambda c: jriccati.convexify(c, 1e-3, method=method))(jc)
    mine = riccati.convexify(tc, 1e-3, method=method)
    # eigh: eigenvector bases differ between LAPACK builds, the clamped
    # reconstruction agrees to float32 accuracy of the Hessian's scale.
    np.testing.assert_allclose(
        getattr(mine, field).numpy(), np.asarray(getattr(ref, field)), rtol=RTOL, atol=1e-4)
    for name in set(riccati.LqrCoeffs._fields) - {"Qxx", "Qux", "Quu", "Qf"}:
        assert getattr(mine, name) is getattr(tc, name)


@pytest.mark.parametrize("method", ["eigh", "gershgorin"])
def test_convexify_makes_the_joint_hessians_psd(method):
    leaves = _indefinite_lq(seed=33)
    _, tc = both(leaves)
    joint = lambda c: np.block(  # noqa: E731
        [[c.Qxx.numpy(), np.swapaxes(c.Qux.numpy(), -1, -2)], [c.Qux.numpy(), c.Quu.numpy()]])
    assert np.linalg.eigvalsh(joint(tc)).min() < -0.1
    out = riccati.convexify(tc, 1e-3, method=method)
    assert np.linalg.eigvalsh(joint(out)).min() > 1e-3 - 1e-4
    assert np.linalg.eigvalsh(out.Qf.numpy()).min() > 1e-3 - 1e-4
    assert out.Quu.is_contiguous() and out.Qxx.is_contiguous() and out.Qux.is_contiguous()


def test_convexify_leaves_a_dominant_diagonal_untouched_and_refuses_unknown_methods():
    leaves = lq_numpy(2, 3, 4, 2, seed=35)
    for k, n in (("Qxx", 4), ("Quu", 2), ("Qf", 4)):
        leaves[k] = np.broadcast_to(5.0 * np.eye(n, dtype=np.float32), leaves[k].shape).copy()
    leaves["Qux"] = 0.01 * leaves["Qux"]
    _, tc = both(leaves)
    out = riccati.convexify(tc, 1e-5, method="gershgorin")
    np.testing.assert_allclose(out.Qxx.numpy(), tc.Qxx.numpy(), atol=1e-7)
    np.testing.assert_allclose(out.Quu.numpy(), tc.Quu.numpy(), atol=1e-7)
    with pytest.raises(ValueError, match="Hessian correction"):
        riccati.convexify(tc, method="cholesky")


# -- the widest pair, (48, 12): the loopshaped legged problem ------------------


def test_strict_plain_version_places_nan_as_jax_single_at_48_12():
    """The strict sweep at the loopshaped problem's (48, 12): a Quu that is
    not positive definite at node 2 of the second scenario gives NaN there
    and at every earlier node, element for element as the JAX
    single-scenario sweep; the first scenario agrees with it at the
    kernel's tolerance."""
    leaves = lq_numpy(2, 5, 48, 12, seed=48)
    leaves["Quu"][1, 2] = -100.0 * np.eye(12, dtype=np.float32)
    _, tc = both(leaves)
    mine = riccati._lqr_backward_batched(tc, torch.as_tensor([1e-6, 0.0]), strict=True)
    single = jax.jit(jriccati._lqr_backward_single)
    for i, reg in enumerate((1e-6, 0.0)):
        ref = single(_single(leaves, i)[0], jnp.asarray(reg, jnp.float32))
        for f in FIELDS:
            a, b = getattr(mine, f).numpy()[i], np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isnan(mine.gains[1, :3].numpy()).all() and np.isfinite(mine.gains[1, 3:].numpy()).all()
    assert np.isfinite(mine.gains[0].numpy()).all()


def test_launch_geometry_at_48_12():
    """A group of 8 warps (each thread 2-3 of the 576 2 x 2 tiles of a 48 x 48
    product), 89,248 bytes a scenario, one scenario a block at B = 1 and
    B = 256 (256 threads fill the kernel's launch bounds), every leaf by the
    bulk copy; the wrapper accepts the pair and refuses it only for the
    device."""
    assert riccati_cuda.threads_per_scenario(48, 12) == 256
    assert riccati_cuda.shared_bytes_per_scenario(48, 12) == 89248
    for batch in (1, 256):
        g = riccati_cuda.launch_geometry(48, 12, batch)
        assert (g.blocks, g.threads, g.shared_bytes, g.scenarios_per_block) == (
            batch, 256, 89248, 1)
    assert set(riccati_cuda.copy_widths(48, 12).values()) == {16}
    c = convert.lqr_coeffs_from_numpy(lq_numpy(2, 2, 48, 12, seed=9), device="cpu")
    assert riccati_cuda.check_inputs(c, torch.zeros(2)) == (2, 2, 48, 12)
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati_cuda.lqr_backward_cuda(c, torch.zeros(2))


# -- the kernel's arithmetic, compiled for the host ------------------------------

HOST_RTOL, HOST_ATOL = 1e-5, 1e-6

_HOST_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
struct Dim3 { unsigned x = 0; };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
extern thread_local Dim3 threadIdx, blockIdx;
extern thread_local std::barrier<>* t_group_barrier;
extern thread_local std::barrier<>* t_block_barrier;
inline void __syncthreads() { t_block_barrier->arrive_and_wait(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
enum cudaError_t { cudaSuccess = 0 };
"""

# Host stand-ins for the kernel's device intrinsics: a group's barrier is a
# barrier of its own threads; a copy lands at once; an mbarrier counts its
# arrivals and its bytes and completes a phase when both reach zero, as the
# card's does, and a wait blocks until the phase of its parity completed.
_HOST_INTRINSICS = r"""
constexpr int kTilesWide = ((NX > NU ? NX : NU) + 1) / 2;
constexpr int kGroupWarps =
    (kTilesWide * kTilesWide + 16) / 32 < 1 ? 1
    : ((kTilesWide * kTilesWide + 16) / 32 > 8 ? 8 : (kTilesWide * kTilesWide + 16) / 32);
constexpr int G = 32 * kGroupWarps;

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float quiet_nan() { return __int_as_float(0x7fc00000); }
inline float reciprocal(float x) { return 1.0f / x; }
inline void group_sync(int) { t_group_barrier->arrive_and_wait(); }

struct HostMbarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
  void complete_if_done() {
    if (pending == 0 && tx == 0) {
      ++phase;
      pending = count;
      cv.notify_all();
    }
  }
};
inline HostMbarrier* host_mbarrier(uint64_t* bar) {
  static std::mutex table_mutex;
  static std::map<const void*, std::unique_ptr<HostMbarrier>> table;
  std::lock_guard<std::mutex> lock(table_mutex);
  auto& slot = table[bar];
  if (!slot) slot.reset(new HostMbarrier());
  return slot.get();
}
inline void mbarrier_init(uint64_t* bar, int count) {
  HostMbarrier* h = host_mbarrier(bar);
  std::lock_guard<std::mutex> lock(h->m);
  h->count = h->pending = count;
  h->tx = 0;
  h->phase = 0;
}
inline void mbarrier_init_fence() {}
inline void mbarrier_expect_bytes(uint64_t* bar, int bytes) {
  HostMbarrier* h = host_mbarrier(bar);
  std::lock_guard<std::mutex> lock(h->m);
  h->tx += bytes;
  --h->pending;
  h->complete_if_done();
}
inline void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  HostMbarrier* h = host_mbarrier(bar);
  std::unique_lock<std::mutex> lock(h->m);
  h->cv.wait(lock, [&] { return (h->phase & 1u) != parity; });
}
inline void async_proxy_fence() {}
inline void bulk_copy(float* dst, const float* src, int bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  HostMbarrier* h = host_mbarrier(bar);
  std::lock_guard<std::mutex> lock(h->m);
  h->tx -= bytes;
  h->complete_if_done();
}
inline void copy4(float* dst, const float* src) { *dst = *src; }
inline void copy4_arrive(uint64_t* bar) {
  HostMbarrier* h = host_mbarrier(bar);
  std::lock_guard<std::mutex> lock(h->m);
  --h->pending;
  h->complete_if_done();
}
"""

_HOST_MAIN = r"""
#include "cuda_runtime.h"
#include <thread>
#include <vector>
thread_local Dim3 threadIdx, blockIdx;
thread_local std::barrier<>* t_group_barrier;
thread_local std::barrier<>* t_block_barrier;
alignas(16) static unsigned char smem_block[232448];
#include "kernel_body.inc"
extern "C" int host_shared_bytes() { return kScenarioBytes; }
extern "C" int host_threads_per_scenario() { return G; }
extern "C" void host_run(const float* A, const float* Bm, const float* bv, const float* Qxx,
    const float* qx, const float* Quu, const float* qu, const float* Qux, const float* Qf,
    const float* qf, const float* reg, float* gains, float* kff, float* vS, float* vs,
    float* dv1, float* dv2, int batch, int n, int spb, int strict) {
  for (int bk = 0; bk < (batch + spb - 1) / spb; ++bk) {
    std::barrier<> block(spb * G);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int w = 0; w < spb; ++w) bars.emplace_back(new std::barrier<>(G));
    std::vector<std::thread> lanes;
    for (int t = 0; t < spb * G; ++t) {
      std::barrier<>* bar = bars[t / G].get();
      lanes.emplace_back([=, &block] {
        threadIdx.x = t;
        blockIdx.x = bk;
        t_group_barrier = bar;
        t_block_barrier = &block;
        riccati_backward_kernel(A, Bm, bv, Qxx, qx, Quu, qu, Qux, Qf, qf, reg, gains, kff, vS,
                                vs, dv1, dv2, batch, n, spb, strict);
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
    barrier a barrier of its own threads, the stage barriers counted as on
    the card."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    from ocs2_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / riccati_cuda.SOURCE).read_text()
    body = src.split("// -- host interface")[0]
    body = re.sub(r"// -- device intrinsics.*?// -- end of device intrinsics[^\n]*\n",
                  lambda _: _HOST_INTRINSICS, body, count=1, flags=re.S)
    body = body.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    body = body.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                        "unsigned char* smem_raw = smem_block;")
    assert "asm" not in body and "__shared__" not in body
    (tmp_path / "cuda_runtime.h").write_text(_HOST_RUNTIME)
    (tmp_path / "kernel_body.inc").write_text(body)
    (tmp_path / "host_main.cpp").write_text(_HOST_MAIN)
    out = tmp_path / f"libhost_{nx}_{nu}.so"
    built = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", f"-I{tmp_path}", f"-DNX={nx}", f"-DNU={nu}", "-o", str(out),
         str(tmp_path / "host_main.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    lib.host_run.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
    return lib


@pytest.mark.parametrize("case", ["loopshaping_48_12_strict_nan", "ballbot_10_3_two_a_block"])
def test_kernel_source_on_the_host_matches_the_plain_version(tmp_path, case):
    """The kernel's phases, barriers, stage pipeline and layout, run on the
    host: equal to the plain version at 1e-5 / 1e-6, with NaN where the
    plain version has it, and the layout's bytes and the group's threads
    equal to the wrapper's.  (48, 12): 256 threads a scenario on one group
    barrier, each thread 2-3 tiles of the 48 x 48 products, every leaf by the
    bulk copy, strict pivots with Quu = -100 I at node 3 of the second
    scenario.  (10, 3): 32 threads a scenario, two scenarios a block and an
    odd batch (the last block's second group leaves at once), six leaves by
    4-byte copies that arrive on the stage barrier one by one, clamped
    pivots.  The absolute tolerance is 1e-6 times the field's largest entry
    (at least 1): at (48, 12) the plain version itself is 4.0e-6 from a
    float64 sweep in value_S (largest entry 9.4), and an entry that
    cancels to 0.02 from products of depth 48 keeps that absolute error
    whatever the order of the sums."""
    if case == "loopshaping_48_12_strict_nan":
        nx, nu, batch, n, spb, strict = 48, 12, 2, 6, 1, True
    else:
        nx, nu, batch, n, spb, strict = 10, 3, 3, 8, 2, False
    lib = _host_kernel(tmp_path, nx, nu)
    assert lib.host_shared_bytes() == riccati_cuda.shared_bytes_per_scenario(nx, nu)
    assert lib.host_threads_per_scenario() == riccati_cuda.threads_per_scenario(nx, nu)
    leaves = lq_numpy(batch, n, nx, nu, seed=50 + nx)
    if strict:
        leaves["Quu"][1, 3] = -100.0 * np.eye(nu, dtype=np.float32)
        assert riccati_cuda.launch_geometry(nx, nu, batch).scenarios_per_block == spb
    _, tc = both(leaves)
    reg = torch.as_tensor(np.resize(np.float32([1e-6, 0.0, 0.1, 2.0]), batch))
    out = riccati.LqrSolution(
        torch.full((batch, n, nu, nx), 7.0), torch.full((batch, n, nu), 7.0),
        torch.full((batch, n + 1, nx, nx), 7.0), torch.full((batch, n + 1, nx), 7.0),
        torch.full((batch,), 7.0), torch.full((batch,), 7.0))
    lib.host_run(*(t.data_ptr() for t in (*tc, reg, *out)), batch, n, spb, int(strict))
    ref = riccati._lqr_backward_batched(tc, reg, strict=strict)
    for f in FIELDS:
        a, b = getattr(out, f).numpy(), getattr(ref, f).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        scale = max(1.0, float(np.abs(b[~np.isnan(b)]).max()))
        np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)], rtol=HOST_RTOL,
                                   atol=HOST_ATOL * scale, err_msg=f)
    assert np.isnan(ref.gains.numpy()).any() == strict
