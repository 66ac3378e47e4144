"""K6, the continuous-time Riccati ODE sweep of SLQ
(``csrc/riccati_ct_backward.cu``): its operations and bytes for
(B, N, nx, nu, substeps), whatever implements the sweep.

Bytes: the node data A, B, Q, q, R, r, P at N + 1 nodes, the jump data at N
intervals, the terminal Qf, qf, the shared grid and the regularization read
once; gains, feedforward, the value function at N + 1 nodes and the two
expected-decrease terms written once.  Operations: per right-hand side
evaluation the interpolation of the node data, A'S (S A is its transpose),
B'S and B's, A's, the nu x nu Cholesky and its solve of nx + 1 columns, the
symmetric G'K, G'k and the stage sums, 4 * substeps evaluations an interval;
per interval the RK4 step ends, the jump branch, the blend, node k's gains
and the expected decrease."""

KERNEL = "riccati_ct_backward_kernel"
COUNTER_MODULE = "ocs2_tpu_torch.ops.riccati_ct_cuda"


def work(batch: int, n: int, nx: int, nu: int, substeps: int):
    node = 2 * nx * nx + nx * nu + nx + nu * nu + nu + nu * nx
    floats_in = batch * ((n + 1) * node + n * (2 * nx * nx + nx) + nx * nx + nx + 1) + 2 * n + 1
    floats_out = batch * (n * (nu * nx + nu) + (n + 1) * (nx * nx + nx) + 2)
    solve = nu ** 3 // 3 + 2 * nu * nu * (nx + 1)
    per_eval = (
        2 * node
        + 2 * nx ** 3 + 2 * nu * nx * (nx + 1)
        + 2 * nx * nx + solve
        + 2 * nu * nx * nx + 2 * nu * nx
        + 6 * (nx * nx + nx)
    )
    per_interval = (
        4 * substeps * per_eval + substeps * 4 * (nx * nx + nx)
        + 4 * nx ** 3 + 4 * nx * nx
        + 3 * (nx * nx + nx)
        + 2 * nu * nx * (nx + 1) + solve + 4 * nu * nu
    )
    return batch * n * per_interval, 4 * (floats_in + floats_out)
