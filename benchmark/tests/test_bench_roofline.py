"""The K1 and K6 counts against hand-worked counts at the smallest shape,
nx = 2, nu = 1, one scenario, one interval."""
from harness.spec import load_module


def test_k1_by_hand():
    flops, nbytes = load_module("roofline", "k1").work(1, 1, 2, 1)
    # Read: A 4, B 2, b 2, Qxx 4, qx 2, Quu 1, qu 1, Qux 2; Qf 4, qf 2, reg 1.
    # Written: K 2, kff 1, S 2 x 4, s 2 x 2, dv1, dv2.
    assert nbytes == 4 * ((4 + 2 + 2 + 4 + 2 + 1 + 1 + 2) + (4 + 2 + 1) + (2 + 1) + 8 + 4 + 2)
    # S b, A' sv 16; B' sv 4; S B 8; S A 16; B' (S B) upper 4; B' (S A) 8;
    # A' (S A) upper 12; Cholesky 0, solves 6; Quu_hat K, Quu_hat kff 6;
    # K' Quu_hat K and K' Qux + Qux' K 18, s update 12; symmetrize 8, dv 4.
    assert flops == 16 + 4 + 8 + 16 + 4 + 8 + 12 + 6 + 6 + 18 + 12 + 8 + 4


def test_k6_by_hand():
    flops, nbytes = load_module("roofline", "k6").work(1, 1, 2, 1, 1)
    # Node data at 2 nodes: A 4, B 2, Q 4, q 2, R 1, r 1, P 2 = 16 each;
    # jump data 4 + 4 + 2; Qf 4, qf 2, reg 1; the grid's 2 times and 1 mask.
    # Written: K 2, kff 1, S 2 x 4, s 2 x 2, dv1, dv2.
    assert nbytes == 4 * ((2 * 16 + 10 + 7 + 3) + (3 + 12 + 2))
    # One evaluation: interpolation 32, A'S 16, [B'S | B's] 12, A's 8,
    # Cholesky and solve 6, G'K 8, G'k 4, sums 36 = 122; four of them.
    # Step ends 24, jump branch 48, blend 18, gains 12 + 6, dv 4.
    assert flops == 4 * 122 + 24 + 48 + 18 + 12 + 6 + 4


def test_shapes_of_the_cells():
    """The cells' kernels at their shapes (the counts of the sweeps' earlier
    bound in chip_smoke.py, without its latency term)."""
    k1 = load_module("roofline", "k1").work(256, 100, 24, 12)
    k6 = load_module("roofline", "k6").work(4096, 32, 10, 3, 4)
    assert k1 == (2965094400, 291228672)
    assert k6 == (11352014848, 341197060)
