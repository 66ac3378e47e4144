"""K1, the discrete Riccati backward sweep (``csrc/riccati_backward.cu``):
its operations and bytes for (B, N, nx, nu), whatever implements the sweep.

Bytes: the stage data A, B, b, Qxx, qx, Quu, qu, Qux of N nodes, the terminal
Qf, qf and the regularization read once; the gains, feedforward, value
function at N + 1 nodes and the two expected-decrease terms written once.
Operations of one node: S b, A' sv, B' sv; S B, S A; B' (S B) at its upper
triangle, B' (S A), A' (S A) at its upper triangle; the Cholesky factor of
Quu_hat and its two solves; Quu_hat K and Quu_hat kff; the S update
K' (Quu_hat K) and K' Qux + Qux' K, both symmetric, and the s update;
the symmetrization and the expected decrease."""

KERNEL = "riccati_backward_kernel"
COUNTER_MODULE = "ocs2_tpu_torch.ops.riccati_cuda"


def work(batch: int, n: int, nx: int, nu: int):
    floats_in = batch * n * (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu)
    floats_in += batch * (nx * nx + nx + 1)
    floats_out = batch * n * (nx * nu + nu) + batch * (n + 1) * (nx * nx + nx) + 2 * batch
    per_node = (
        4 * nx * nx + 2 * nx * nu
        + 2 * nx * nx * nu + 2 * nx ** 3
        + nx * nu * (nu + 1) + 2 * nx * nx * nu
        + nx * nx * (nx + 1)
        + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)
        + 2 * nu * nu * (nx + 1)
        + 3 * nx * (nx + 1) * nu + 6 * nx * nu
        + 2 * nx * nx + 4 * nu
    )
    return batch * n * per_node, 4 * (floats_in + floats_out)
