// Batched discrete-time Riccati backward sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `lqr_backward_pallas` / `_kernel` of
// ocs2_tpu/ops/riccati_pallas.py.  Its plain PyTorch version is
// `_lqr_backward_batched` in ocs2_tpu_torch/ops/riccati.py; the wrapper is
// ocs2_tpu_torch/ops/riccati_cuda.py.
//
// What it computes, per scenario and for k = N-1 ... 0:
//   sv      = s + S b
//   qu_hat  = qu + B' sv            qx_hat  = qx + A' sv
//   Quu_hat = Quu + B' S B + reg I  Qux_hat = Qux + B' S A
//   Qxx_hat = Qxx + A' S A
//   K = -Quu_hat^-1 Qux_hat         kff = -Quu_hat^-1 qu_hat
//   S <- sym(Qxx_hat + K' Quu_hat K + K' Qux_hat + Qux_hat' K)
//   s <- qx_hat + K' Quu_hat kff + K' qu_hat + Qux_hat' kff
//   dv1 += kff . qu_hat             dv2 += 1/2 kff' Quu_hat kff
// The solve is a Cholesky-type elimination whose pivots p (the squares of the
// Cholesky diagonal) follow one of two policies, chosen at launch:
//   clamp   p <- max(p, 1e-12): the sweep never fails (batched solves);
//   strict  a pivot p <= 0 or non-finite becomes NaN, which reaches K, kff,
//           S, s of that node and of every earlier one and dv1, dv2 (a single
//           solve, whose caller masks the step on it).
//
// What bounds it.  With many scenarios the sweep is bound by bytes: per
// scenario and node it reads 2 nx^2 + 2 nx nu + nu^2 + 2 nx + nu floats and
// writes nx^2 + nx nu + nx + nu, against a few tens of thousands of
// operations.  With few scenarios (one tick of a controller, a batch of a few
// hundred) it is bound by the chain of N dependent nodes: node k cannot
// start before S of node k+1 is known, and inside a node the products that
// feed Quu_hat, the nu pivots of the elimination, the back substitution and
// the S update follow one another.  The design serves both ends.
//
// * A group of threads per scenario.  G = 32 ... 256 threads (whole warps, from
//   (nx, nu) at compile time) cover each matrix as a grid of 2 x 2 register
//   tiles, so that two shared-memory reads of 8 bytes feed four
//   multiply-adds; S, S A, S B, the hatted blocks, K and the elimination's
//   working matrix live in shared memory for the sweep.  The time loop runs
//   INSIDE the kernel (the TPU kernel made time a sequential grid axis with
//   (S, s) in scratch memory; blocks of a CUDA grid run in no order).  A block
//   holds `spb` groups, chosen by the wrapper from the batch at launch: one
//   scenario a block while the batch is smaller than the card (256 scenarios
//   at (24, 12) are 256 blocks on 132 SMs), several once every SM has work.
//   Groups of a block never wait for each other: after the set-up they meet
//   only on their own barrier (`__syncwarp` for G = 32, a named barrier
//   `bar.sync 1 + group, G` otherwise), and groups past the ragged end of the
//   batch leave at once.
// * The standard layout.  Operands are [B, N, n, m] contiguous as the solvers
//   hold them and results are written so.  A scenario's node is then one
//   contiguous run of each leaf (2,304 bytes of A at nx = 24), which one
//   thread can ask the copy engine for, and no layout copy surrounds the
//   launch.
// * Node k-1 on its way while node k computes.  Two stages of operand buffers
//   per scenario, an `mbarrier` each.  A leaf whose per-node run is a multiple
//   of 16 bytes comes by the 1-D bulk copy (`cp.async.bulk`, issued by the
//   group's first thread, completion counted in bytes on the barrier); any
//   other leaf by 4-byte `cp.async` spread over the group's threads, tracked by
//   the same barrier (`cp.async.mbarrier.arrive.noinc`).  The choice is per
//   leaf and compile-time.
// * The elimination across the group.  The working matrix is
//   [Quu_hat | Qux_hat | qu_hat], nu x (nu + nx + 1), a 2 x 2 tile of it in
//   each thread's registers.  Column step c subtracts row c, scaled by
//   M[c][i] / p_c, from every row i > c: a right-looking factorization that
//   keeps the rows unscaled (row c ends as d_c times row c of the Cholesky
//   factor's transpose, d_c^2 = p_c), so that a step reads only row c, needs
//   no square root, writes only row c + 1 back and takes ONE barrier; the
//   right-hand sides of K and kff ride along as further columns.  The back
//   substitution gives
//   each of the nx + 1 columns to one thread, in registers, with no barrier.
// * Barriers per node: nu + 5 of one group (S A, S B, sv | hatted blocks |
//   nu column steps | K, kff | Quu_hat K + Qux_hat, Quu_hat kff | S, s), none
//   block-wide.  The symmetric S is formed directly (each tile reads the
//   mirrored entries of its terms), which saves the barrier and the round
//   trip through shared memory of a transpose.
//
// FP32 FMA, no tensor cores: the sweep is held to rtol 2e-4 over up to 100
// dependent nodes, TF32 keeps about three digits, and a 64-row `wgmma` tile
// has nothing to do with 24 x 24 matrices.  No fast-math: the pivots'
// reciprocals are correctly rounded (`__frcp_rn`).
//
// With -DRICCATI_PHASE_CLOCKS the first thread of the grid prints the cycles a
// node spends in each phase (tools/riccati_phase_clocks.py); the library the
// solvers load is built without it.
//
// NX and NU are compile-time constants (one library per pair, -DNX= -DNU=).
// The code between "device intrinsics" and "end of device intrinsics" is the
// only part that is not plain C++: every phase below it is a function of the
// thread's index within its group, called between two barriers.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#ifdef RICCATI_PHASE_CLOCKS
#include <cstdio>
#endif

#ifndef NX
#error "compile with -DNX=<state dim>"
#endif
#ifndef NU
#error "compile with -DNU=<input dim>"
#endif

namespace {

// -- device intrinsics ---------------------------------------------------------

constexpr int kTilesWide = ((NX > NU ? NX : NU) + 1) / 2;
constexpr int kGroupWarps =
    (kTilesWide * kTilesWide + 16) / 32 < 1 ? 1
    : ((kTilesWide * kTilesWide + 16) / 32 > 8 ? 8 : (kTilesWide * kTilesWide + 16) / 32);
// Threads per scenario.
constexpr int G = 32 * kGroupWarps;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// 1 / x, correctly rounded (what the IEEE division gives, without its slow path).
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }

__device__ __forceinline__ void group_sync(int group) {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(G) : "memory");
  }
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Orders the group's earlier reads of a stage before the copy engine's writes.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(shared_address(dst)), "l"(src)
               : "memory");
}

// This thread's earlier copy4 calls arrive on `bar` when they have landed.
__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(shared_address(bar))
               : "memory");
}

// -- end of device intrinsics ----------------------------------------------------

constexpr float kPivotEps = 1e-12f;
constexpr int kMaxThreads = 256;          // of a block; the wrapper's limit too
constexpr int kMaxSharedBytes = 232448;   // 227 KB
constexpr int kMaxNamedBarriers = 15;     // bar.sync 1 ... 15

constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// A leaf's per-node run goes by the bulk copy if it is a multiple of 16 bytes.
constexpr bool is_bulk(int floats) { return floats % 4 == 0; }
constexpr int bulk_bytes(int floats) { return is_bulk(floats) ? 4 * floats : 0; }

// One stage of operands: the eight per-node leaves, each 16-byte aligned.
constexpr int kLenA = NX * NX, kLenB = NX * NU, kLenb = NX, kLenQxx = NX * NX, kLenqx = NX,
              kLenQuu = NU * NU, kLenqu = NU, kLenQux = NU * NX;
constexpr int oA = 0;
constexpr int oB = oA + pad4(kLenA);
constexpr int ob = oB + pad4(kLenB);
constexpr int oQxx = ob + pad4(kLenb);
constexpr int oqx = oQxx + pad4(kLenQxx);
constexpr int oQuu = oqx + pad4(kLenqx);
constexpr int oqu = oQuu + pad4(kLenQuu);
constexpr int oQux = oqu + pad4(kLenqu);
constexpr int kStageFloats = oQux + pad4(kLenQux);
constexpr int kBulkBytes = bulk_bytes(kLenA) + bulk_bytes(kLenB) + bulk_bytes(kLenb) +
                           bulk_bytes(kLenQxx) + bulk_bytes(kLenqx) + bulk_bytes(kLenQuu) +
                           bulk_bytes(kLenqu) + bulk_bytes(kLenQux);
constexpr bool kAnySmall = !(is_bulk(kLenA) && is_bulk(kLenB) && is_bulk(kLenb) &&
                             is_bulk(kLenQxx) && is_bulk(kLenqx) && is_bulk(kLenQuu) &&
                             is_bulk(kLenqu) && is_bulk(kLenQux));
// Arrivals that complete a stage: the first thread's expect_tx, and every
// thread's copy4_arrive where a leaf goes by 4-byte copies.
constexpr int kStageArrivals = (kBulkBytes > 0 ? 1 : 0) + (kAnySmall ? G : 0);

// What a scenario keeps in shared memory for the whole sweep.
constexpr int MW = NU + NX + 1;  // width of the elimination's working matrix
constexpr int oS = 0;                          // [NX, NX] value Hessian
constexpr int oSA = oS + pad4(NX * NX);        // [NX, NX] S A
constexpr int oQXXH = oSA + pad4(NX * NX);     // [NX, NX] Qxx_hat
constexpr int oSB = oQXXH + pad4(NX * NX);     // [NX, NU] S B
constexpr int oQUX = oSB + pad4(NX * NU);      // [NU, NX] Qux_hat
constexpr int oK = oQUX + pad4(NU * NX);       // [NU, NX] K
constexpr int oWQ = oK + pad4(NU * NX);        // [NU, NX] Quu_hat K + Qux_hat
constexpr int oQUU = oWQ + pad4(NU * NX);      // [NU, NU] Quu_hat
constexpr int oM = oQUU + pad4(NU * NU);       // [NU, MW] [Quu_hat | Qux_hat | qu_hat], eliminated
constexpr int oSVEC = oM + pad4(NU * MW);      // [NX] value gradient s
constexpr int oSV = oSVEC + pad4(NX);          // [NX] s + S b
constexpr int oQXH = oSV + pad4(NX);           // [NX] qx_hat
constexpr int oQUH = oQXH + pad4(NX);          // [NU] qu_hat
constexpr int oKF = oQUH + pad4(NU);           // [NU] kff
constexpr int oQUUKF = oKF + pad4(NU);         // [NU] Quu_hat kff
constexpr int oPINV = oQUUKF + pad4(NU);       // [NU] 1 / pivot
constexpr int oSTAGE = oPINV + pad4(NU);       // two stages of operands
constexpr int kScenarioFloats = oSTAGE + 2 * kStageFloats;
// Bytes of shared memory per scenario: its two stage barriers and its floats.
constexpr int kScenarioBytes = 16 + 4 * kScenarioFloats;

// The per-scenario pointers of the operands and results in device memory.
struct Rows {
  const float *A, *B, *b, *Qxx, *qx, *Quu, *qu, *Qux;  // node 0 of the scenario
  float *gains, *kff, *vS, *vs;                        // node 0 of the scenario
};

// -- 2 x 2 register tiles --------------------------------------------------------

// Two neighbouring floats of a row with NCOLS columns; one 8-byte access when
// NCOLS is even (rows start 8-byte aligned, j0 is even).  Past an odd edge the
// second value repeats the first and is never stored.
template <int NCOLS>
__device__ __forceinline__ void load_pair(const float* row, int j0, float& a, float& b) {
  if constexpr (NCOLS % 2 == 0) {
    const float2 v = *reinterpret_cast<const float2*>(row + j0);
    a = v.x;
    b = v.y;
  } else {
    a = row[j0];
    b = row[j0 + 1 < NCOLS ? j0 + 1 : j0];
  }
}

template <int NCOLS>
__device__ __forceinline__ void store_pair(float* row, int j0, float a, float b) {
  if constexpr (NCOLS % 2 == 0) {
    *reinterpret_cast<float2*>(row + j0) = make_float2(a, b);
  } else {
    row[j0] = a;
    if (j0 + 1 < NCOLS) row[j0 + 1] = b;
  }
}

// Tile t of an R x C matrix: rows i0, i1 (i1 = i0 at an odd edge, then `two`
// is false and row i1 is not stored), columns j0, j0 + 1.
template <int R, int C>
struct Tile {
  static constexpr int kCount = ((R + 1) / 2) * ((C + 1) / 2);
  int i0, i1, j0;
  bool two;
  __device__ __forceinline__ explicit Tile(int t) {
    constexpr int ntj = (C + 1) / 2;
    i0 = 2 * (t / ntj);
    j0 = 2 * (t % ntj);
    two = i0 + 1 < R;
    i1 = two ? i0 + 1 : i0;
  }
};

// acc += X' Y on the tile: X is [DEPTH, XC], Y is [DEPTH, YC], both read by rows.
template <int DEPTH, int XC, int YC>
__device__ __forceinline__ void mac_tn(const float* x, const float* y, int i0, int j0,
                                       float (&acc)[2][2]) {
#pragma unroll
  for (int c = 0; c < DEPTH; ++c) {
    float xa, xb, ya, yb;
    load_pair<XC>(x + c * XC, i0, xa, xb);
    load_pair<YC>(y + c * YC, j0, ya, yb);
    acc[0][0] += xa * ya;
    acc[0][1] += xa * yb;
    acc[1][0] += xb * ya;
    acc[1][1] += xb * yb;
  }
}

// acc += X Y on the tile: X is [., DEPTH] (rows i0, i1), Y is [DEPTH, YC].
template <int DEPTH, int YC>
__device__ __forceinline__ void mac_nn(const float* x, const float* y, int i0, int i1, int j0,
                                       float (&acc)[2][2]) {
#pragma unroll
  for (int c = 0; c < DEPTH; ++c) {
    const float xa = x[i0 * DEPTH + c], xb = x[i1 * DEPTH + c];
    float ya, yb;
    load_pair<YC>(y + c * YC, j0, ya, yb);
    acc[0][0] += xa * ya;
    acc[0][1] += xa * yb;
    acc[1][0] += xb * ya;
    acc[1][1] += xb * yb;
  }
}

template <int R, int C>
__device__ __forceinline__ void store_tile(float* m, const Tile<R, C>& t, const float (&v)[2][2]) {
  store_pair<C>(m + t.i0 * C, t.j0, v[0][0], v[0][1]);
  if (t.two) store_pair<C>(m + t.i1 * C, t.j0, v[1][0], v[1][1]);
}

// The first job of thread `tid` in a list that follows `taken` earlier jobs of
// the same phase: the threads the earlier list left idle start first.
__device__ __forceinline__ int first_job(int tid, int taken) { return (tid + G - taken % G) % G; }

// -- the operand pipeline -------------------------------------------------------

// Leaf number SLOT of a node.  A bulk copy is one instruction of one thread;
// the eight leaves go to the first lanes of different warps, so that no warp
// pays for all of them.
template <int LEN, int SLOT>
__device__ __forceinline__ void fetch_leaf(float* dst, const float* src, uint64_t* bar, int tid) {
  if constexpr (LEN % 4 == 0) {  // is_bulk(LEN)
    if (tid == 32 * (SLOT % kGroupWarps)) {
      async_proxy_fence();
      bulk_copy(dst, src, 4 * LEN, bar);
    }
  } else {
    for (int e = tid; e < LEN; e += G) copy4(dst + e, src + e);
  }
}

// Starts the copies of node k's operands into stage buffer `st`; `bar` flips
// when all of them have landed (the bytes may land before they are expected:
// the phase cannot complete before the first thread's arrival).  Called by
// every thread of the group.
__device__ __forceinline__ void fetch_node(float* st, uint64_t* bar, const Rows& g, int k, int tid) {
  const size_t kk = static_cast<size_t>(k);
  if constexpr (kBulkBytes > 0) {
    if (tid == 0) mbarrier_expect_bytes(bar, kBulkBytes);
  }
  fetch_leaf<kLenA, 0>(st + oA, g.A + kk * kLenA, bar, tid);
  fetch_leaf<kLenQxx, 1>(st + oQxx, g.Qxx + kk * kLenQxx, bar, tid);
  fetch_leaf<kLenB, 2>(st + oB, g.B + kk * kLenB, bar, tid);
  fetch_leaf<kLenQux, 3>(st + oQux, g.Qux + kk * kLenQux, bar, tid);
  fetch_leaf<kLenQuu, 4>(st + oQuu, g.Quu + kk * kLenQuu, bar, tid);
  fetch_leaf<kLenb, 5>(st + ob, g.b + kk * kLenb, bar, tid);
  fetch_leaf<kLenqx, 6>(st + oqx, g.qx + kk * kLenqx, bar, tid);
  fetch_leaf<kLenqu, 7>(st + oqu, g.qu + kk * kLenqu, bar, tid);
  if constexpr (kAnySmall) copy4_arrive(bar);
}

// -- the phases of a node; a group barrier follows each --------------------------

// S A, S B and sv = s + S b.
__device__ __forceinline__ void phase_products(float* sm, const float* st, int tid) {
  using TXX = Tile<NX, NX>;
  using TXU = Tile<NX, NU>;
  for (int t = tid; t < TXX::kCount; t += G) {
    const TXX tile(t);
    float acc[2][2] = {};
    mac_nn<NX, NX>(sm + oS, st + oA, tile.i0, tile.i1, tile.j0, acc);
    store_tile(sm + oSA, tile, acc);
  }
  for (int t = first_job(tid, TXX::kCount); t < TXU::kCount; t += G) {
    const TXU tile(t);
    float acc[2][2] = {};
    mac_nn<NX, NU>(sm + oS, st + oB, tile.i0, tile.i1, tile.j0, acc);
    store_tile(sm + oSB, tile, acc);
  }
  for (int j = first_job(tid, TXX::kCount + TXU::kCount); j < NX; j += G) {
    float acc = sm[oSVEC + j];
#pragma unroll
    for (int c = 0; c < NX; ++c) acc += sm[oS + j * NX + c] * st[ob + c];
    sm[oSV + j] = acc;
  }
}

// Qxx_hat, Qux_hat, Quu_hat, qx_hat, qu_hat; the working matrix M is set up.
__device__ __forceinline__ void phase_hats(float* sm, const float* st, float reg, int tid) {
  using TXX = Tile<NX, NX>;
  using TUX = Tile<NU, NX>;
  using TUU = Tile<NU, NU>;
  for (int t = tid; t < TXX::kCount; t += G) {
    const TXX tile(t);
    float acc[2][2];
    load_pair<NX>(st + oQxx + tile.i0 * NX, tile.j0, acc[0][0], acc[0][1]);
    load_pair<NX>(st + oQxx + tile.i1 * NX, tile.j0, acc[1][0], acc[1][1]);
    mac_tn<NX, NX, NX>(st + oA, sm + oSA, tile.i0, tile.j0, acc);
    store_tile(sm + oQXXH, tile, acc);
  }
  for (int t = first_job(tid, TXX::kCount); t < TUX::kCount; t += G) {
    const TUX tile(t);
    float acc[2][2];
    load_pair<NX>(st + oQux + tile.i0 * NX, tile.j0, acc[0][0], acc[0][1]);
    load_pair<NX>(st + oQux + tile.i1 * NX, tile.j0, acc[1][0], acc[1][1]);
    mac_tn<NX, NU, NX>(st + oB, sm + oSA, tile.i0, tile.j0, acc);
    store_tile(sm + oQUX, tile, acc);
    float* m0 = sm + oM + tile.i0 * MW + NU + tile.j0;
    float* m1 = sm + oM + tile.i1 * MW + NU + tile.j0;
    const bool wide = tile.j0 + 1 < NX;
    m0[0] = acc[0][0];
    if (wide) m0[1] = acc[0][1];
    if (tile.two) {
      m1[0] = acc[1][0];
      if (wide) m1[1] = acc[1][1];
    }
  }
  for (int t = first_job(tid, TXX::kCount + TUX::kCount); t < TUU::kCount; t += G) {
    const TUU tile(t);
    float acc[2][2];
    load_pair<NU>(st + oQuu + tile.i0 * NU, tile.j0, acc[0][0], acc[0][1]);
    load_pair<NU>(st + oQuu + tile.i1 * NU, tile.j0, acc[1][0], acc[1][1]);
    mac_tn<NX, NU, NU>(st + oB, sm + oSB, tile.i0, tile.j0, acc);
    if (tile.i0 == tile.j0) {  // the tile lies on the diagonal
      acc[0][0] += reg;
      acc[1][1] += reg;
    }
    store_tile(sm + oQUU, tile, acc);
    // The elimination reads Quu_hat's lower triangle, as a Cholesky
    // factorization does: M gets it mirrored.
    const int rows[2] = {tile.i0, tile.i1}, cols[2] = {tile.j0, tile.j0 + 1};
#pragma unroll
    for (int a = 0; a < (tile.two ? 2 : 1); ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (cols[b] > rows[a] || cols[b] >= NU) continue;
        sm[oM + rows[a] * MW + cols[b]] = acc[a][b];
        sm[oM + cols[b] * MW + rows[a]] = acc[a][b];
      }
    }
  }
  constexpr int kTiles = TXX::kCount + TUX::kCount + TUU::kCount;
  for (int j = first_job(tid, kTiles); j < NX + NU; j += G) {
    if (j < NX) {
      float acc = st[oqx + j];
#pragma unroll
      for (int c = 0; c < NX; ++c) acc += st[oA + c * NX + j] * sm[oSV + c];
      sm[oQXH + j] = acc;
    } else {
      const int i = j - NX;
      float acc = st[oqu + i];
#pragma unroll
      for (int c = 0; c < NX; ++c) acc += st[oB + c * NU + i] * sm[oSV + c];
      sm[oQUH + i] = acc;
      sm[oM + i * MW + NU + NX] = acc;
    }
  }
}

// 1 / pivot under the launch's policy.
__device__ __forceinline__ float pivot_reciprocal(float p, bool strict) {
  if (strict) return (p > 0.0f && p <= FLT_MAX) ? reciprocal(p) : quiet_nan();
  return reciprocal(fmaxf(p, kPivotEps));
}

// The elimination of M.  A thread keeps its 2 x 2 tiles of M in registers
// over the nu column steps.  Step c: rows i > c lose (M[c][i] / p_c) row c in
// the columns j > c; row c and the pivot are only read, from shared memory,
// and row c + 1, final after this step, is written back there (for the next
// step and for the back substitution).  One group barrier follows each step.
struct Elimination {
  using TM = Tile<NU, MW>;
  static constexpr int T = (TM::kCount + G - 1) / G;  // tiles of a thread
  float v[T][2][2];
  int i0[T], i1[T], j0[T], j1[T];  // j1 = j0 at an odd edge: a copy, never stored
  bool valid[T];

  __device__ __forceinline__ void load(const float* sm, int tid) {
    const float* m = sm + oM;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int t = tid + q * G;
      valid[q] = t < TM::kCount;
      const TM tile(valid[q] ? t : 0);
      i0[q] = tile.i0;
      i1[q] = tile.i1;
      j0[q] = tile.j0;
      j1[q] = tile.j0 + 1 < MW ? tile.j0 + 1 : tile.j0;
      v[q][0][0] = m[i0[q] * MW + j0[q]];
      v[q][0][1] = m[i0[q] * MW + j1[q]];
      v[q][1][0] = m[i1[q] * MW + j0[q]];
      v[q][1][1] = m[i1[q] * MW + j1[q]];
    }
  }

  __device__ __forceinline__ void step(float* sm, int c, bool strict, int tid) {
    float* m = sm + oM;
    const float* row_c = m + c * MW;
    const float inv = pivot_reciprocal(row_c[c], strict);
    if (tid == 0) sm[oPINV + c] = inv;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      if (!valid[q] || i1[q] <= c || j1[q] <= c) continue;
      const float l0 = row_c[i0[q]] * inv, l1 = row_c[i1[q]] * inv;
      const float r0 = row_c[j0[q]], r1 = row_c[j1[q]];
      if (i0[q] > c) {
        if (j0[q] > c) v[q][0][0] -= l0 * r0;
        v[q][0][1] -= l0 * r1;
      }
      if (j0[q] > c) v[q][1][0] -= l1 * r0;
      v[q][1][1] -= l1 * r1;
      const int a = i0[q] == c + 1 ? 0 : (i1[q] == c + 1 ? 1 : -1);
      if (a >= 0) {
        float* row = m + (c + 1) * MW;
        row[j0[q]] = a == 0 ? v[q][0][0] : v[q][1][0];
        row[j1[q]] = a == 0 ? v[q][0][1] : v[q][1][1];
      }
    }
  }
};

// Back substitution: column j of [K | kff], one thread each, in registers;
// gains and kff of node k go to device memory.
__device__ __forceinline__ void phase_back_substitute(float* sm, float* gains_k, float* kff_k,
                                                      int tid) {
  const float* m = sm + oM;
  for (int j = tid; j < NX + 1; j += G) {
    float z[NU];
#pragma unroll
    for (int c = NU - 1; c >= 0; --c) {
      float acc = m[c * MW + NU + j];
#pragma unroll
      for (int i = c + 1; i < NU; ++i) acc -= m[c * MW + i] * z[i];
      z[c] = acc * sm[oPINV + c];
    }
    if (j < NX) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        sm[oK + c * NX + j] = -z[c];
        gains_k[c * NX + j] = -z[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        sm[oKF + c] = -z[c];
        kff_k[c] = -z[c];
      }
    }
  }
}

// WQ = Quu_hat K + Qux_hat and Quu_hat kff.
__device__ __forceinline__ void phase_quu_products(float* sm, int tid) {
  using TUX = Tile<NU, NX>;
  for (int t = tid; t < TUX::kCount; t += G) {
    const TUX tile(t);
    float acc[2][2];
    load_pair<NX>(sm + oQUX + tile.i0 * NX, tile.j0, acc[0][0], acc[0][1]);
    load_pair<NX>(sm + oQUX + tile.i1 * NX, tile.j0, acc[1][0], acc[1][1]);
    mac_nn<NU, NX>(sm + oQUU, sm + oK, tile.i0, tile.i1, tile.j0, acc);
    store_tile(sm + oWQ, tile, acc);
  }
  for (int i = first_job(tid, TUX::kCount); i < NU; i += G) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NU; ++c) acc += sm[oQUU + i * NU + c] * sm[oKF + c];
    sm[oQUUKF + i] = acc;
  }
}

// S <- sym(Qxx_hat + K' WQ + Qux_hat' K), s <- qx_hat + K' (Quu_hat kff +
// qu_hat) + Qux_hat' kff; both also go to device memory as node k's value
// function.  Each tile reads the mirrored entries of its terms itself.
__device__ __forceinline__ void phase_value(float* sm, float* vS_k, float* vs_k, int tid) {
  using TXX = Tile<NX, NX>;
  const float* K = sm + oK;
  const float* WQ = sm + oWQ;
  const float* QUX = sm + oQUX;
  const float* QXXH = sm + oQXXH;
  for (int t = tid; t < TXX::kCount; t += G) {
    const TXX tile(t);
    const int j1 = tile.j0 + 1 < NX ? tile.j0 + 1 : tile.j0;
    float acc[2][2];
    acc[0][0] = QXXH[tile.i0 * NX + tile.j0] + QXXH[tile.j0 * NX + tile.i0];
    acc[0][1] = QXXH[tile.i0 * NX + j1] + QXXH[j1 * NX + tile.i0];
    acc[1][0] = QXXH[tile.i1 * NX + tile.j0] + QXXH[tile.j0 * NX + tile.i1];
    acc[1][1] = QXXH[tile.i1 * NX + j1] + QXXH[j1 * NX + tile.i1];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float ki[2], kj[2], wi[2], wj[2], qi[2], qj[2];
      load_pair<NX>(K + c * NX, tile.i0, ki[0], ki[1]);
      load_pair<NX>(K + c * NX, tile.j0, kj[0], kj[1]);
      load_pair<NX>(WQ + c * NX, tile.i0, wi[0], wi[1]);
      load_pair<NX>(WQ + c * NX, tile.j0, wj[0], wj[1]);
      load_pair<NX>(QUX + c * NX, tile.i0, qi[0], qi[1]);
      load_pair<NX>(QUX + c * NX, tile.j0, qj[0], qj[1]);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          acc[a][b] += ki[a] * wj[b] + kj[b] * wi[a] + qi[a] * kj[b] + qj[b] * ki[a];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) acc[a][b] *= 0.5f;
    }
    store_tile(sm + oS, tile, acc);
    store_tile(vS_k, tile, acc);
  }
  for (int j = first_job(tid, TXX::kCount); j < NX; j += G) {
    float acc = sm[oQXH + j];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      acc += K[c * NX + j] * (sm[oQUUKF + c] + sm[oQUH + c]) + QUX[c * NX + j] * sm[oKF + c];
    }
    sm[oSVEC + j] = acc;
    vs_k[j] = acc;
  }
}

// Terminal value function into shared memory and into node N of the results.
__device__ __forceinline__ void phase_terminal(float* sm, const float* Qf, const float* qf,
                                               float* vS_n, float* vs_n, int tid) {
  for (int e = tid; e < NX * NX; e += G) {
    const float v = Qf[e];
    sm[oS + e] = v;
    vS_n[e] = v;
  }
  for (int e = tid; e < NX; e += G) {
    const float v = qf[e];
    sm[oSVEC + e] = v;
    vs_n[e] = v;
  }
}

// dv1 += kff . qu_hat, dv2 += 1/2 kff' Quu_hat kff; the group's first thread.
__device__ __forceinline__ void accumulate_decrease(const float* sm, float& dv1, float& dv2) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    dv1 += sm[oKF + i] * sm[oQUH + i];
    dv2 += 0.5f * sm[oKF + i] * sm[oQUUKF + i];
  }
}

// -- the kernel ---------------------------------------------------------------------

#ifdef RICCATI_PHASE_CLOCKS
#define PHASE_CLOCK(i)                      \
  {                                         \
    const long long now = clock64();        \
    phase_cycles[i] += now - phase_start;   \
    phase_start = now;                      \
  }
#else
#define PHASE_CLOCK(i)
#endif

__global__ void __launch_bounds__(kMaxThreads) riccati_backward_kernel(
    const float* __restrict__ A,    // [B, N, NX, NX]
    const float* __restrict__ Bm,   // [B, N, NX, NU]
    const float* __restrict__ bv,   // [B, N, NX]
    const float* __restrict__ Qxx,  // [B, N, NX, NX]
    const float* __restrict__ qx,   // [B, N, NX]
    const float* __restrict__ Quu,  // [B, N, NU, NU]
    const float* __restrict__ qu,   // [B, N, NU]
    const float* __restrict__ Qux,  // [B, N, NU, NX]
    const float* __restrict__ Qf,   // [B, NX, NX]
    const float* __restrict__ qf,   // [B, NX]
    const float* __restrict__ reg,  // [B]
    float* __restrict__ gains,      // [B, N, NU, NX]
    float* __restrict__ kff,        // [B, N, NU]
    float* __restrict__ vS,         // [B, N+1, NX, NX]
    float* __restrict__ vs,         // [B, N+1, NX]
    float* __restrict__ dv1,        // [B]
    float* __restrict__ dv2,        // [B]
    int batch, int n, int spb, int strict_pivots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x % G;    // thread within its scenario's group
  const int group = threadIdx.x / G;  // scenario within the block
  const int sc = blockIdx.x * spb + group;
  const bool strict = strict_pivots != 0;

  // Shared memory: [spb][2] stage barriers, then kScenarioFloats per scenario.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw) + 2 * group;
  float* sm = reinterpret_cast<float*>(smem_raw + 16 * spb) +
              static_cast<size_t>(group) * kScenarioFloats;
  if (tid == 0) {
    mbarrier_init(&bars[0], kStageArrivals);
    mbarrier_init(&bars[1], kStageArrivals);
    mbarrier_init_fence();
  }
  __syncthreads();
  if (sc >= batch) return;  // past the ragged end; groups meet on no block-wide barrier below

  const size_t b = static_cast<size_t>(sc);
  const size_t nodes = b * static_cast<size_t>(n);
  Rows g;
  g.A = A + nodes * kLenA;
  g.B = Bm + nodes * kLenB;
  g.b = bv + nodes * kLenb;
  g.Qxx = Qxx + nodes * kLenQxx;
  g.qx = qx + nodes * kLenqx;
  g.Quu = Quu + nodes * kLenQuu;
  g.qu = qu + nodes * kLenqu;
  g.Qux = Qux + nodes * kLenQux;
  g.gains = gains + nodes * (NU * NX);
  g.kff = kff + nodes * NU;
  g.vS = vS + (nodes + b) * (NX * NX);
  g.vs = vs + (nodes + b) * NX;

  fetch_node(sm + oSTAGE, &bars[0], g, n - 1, tid);
  phase_terminal(sm, Qf + b * (NX * NX), qf + b * NX, g.vS + static_cast<size_t>(n) * (NX * NX),
                 g.vs + static_cast<size_t>(n) * NX, tid);
  const float r = reg[sc];
  float acc1 = 0.0f, acc2 = 0.0f;  // of the group's first thread
  group_sync(group);

#ifdef RICCATI_PHASE_CLOCKS
  long long phase_cycles[7] = {};
  long long phase_start = clock64();
#endif
  for (int it = 0; it < n; ++it) {
    const int k = n - 1 - it;
    const size_t kk = static_cast<size_t>(k);
    const int stage = it & 1;
    const float* st = sm + oSTAGE + stage * kStageFloats;
    // The other stage was last read two barriers ago: node k-1 can start.
    if (k > 0) fetch_node(sm + oSTAGE + (stage ^ 1) * kStageFloats, &bars[stage ^ 1], g, k - 1, tid);
    mbarrier_wait(&bars[stage], (it >> 1) & 1);
    PHASE_CLOCK(0)

    phase_products(sm, st, tid);
    group_sync(group);
    PHASE_CLOCK(1)
    phase_hats(sm, st, r, tid);
    group_sync(group);
    PHASE_CLOCK(2)
    Elimination elimination;
    elimination.load(sm, tid);
#pragma unroll 1
    for (int c = 0; c < NU; ++c) {
      elimination.step(sm, c, strict, tid);
      group_sync(group);
    }
    PHASE_CLOCK(3)
    phase_back_substitute(sm, g.gains + kk * (NU * NX), g.kff + kk * NU, tid);
    group_sync(group);
    PHASE_CLOCK(4)
    phase_quu_products(sm, tid);
    group_sync(group);
    PHASE_CLOCK(5)
    if (tid == 0) accumulate_decrease(sm, acc1, acc2);
    phase_value(sm, g.vS + kk * (NX * NX), g.vs + kk * NX, tid);
    group_sync(group);
    PHASE_CLOCK(6)
  }
#ifdef RICCATI_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    printf("{\"phase_cycles_per_node\": {\"fetch_and_wait\": %lld, \"products\": %lld, "
           "\"hats\": %lld, \"eliminate\": %lld, \"back_substitute\": %lld, "
           "\"quu_products\": %lld, \"value\": %lld}}\n",
           phase_cycles[0] / n, phase_cycles[1] / n, phase_cycles[2] / n, phase_cycles[3] / n,
           phase_cycles[4] / n, phase_cycles[5] / n, phase_cycles[6] / n);
  }
#endif
  if (tid == 0) {
    dv1[sc] = acc1;
    dv2[sc] = acc2;
  }
}

}  // namespace

// -- host interface -------------------------------------------------------------------

extern "C" int riccati_backward_nx() { return NX; }
extern "C" int riccati_backward_nu() { return NU; }
extern "C" int riccati_backward_threads_per_scenario() { return G; }
extern "C" int riccati_backward_shared_bytes_per_scenario() { return kScenarioBytes; }
// Bit i is set if leaf i of (A, B, b, Qxx, qx, Quu, qu, Qux) goes by the bulk copy.
extern "C" int riccati_backward_bulk_leaves() {
  return (is_bulk(kLenA) << 0) | (is_bulk(kLenB) << 1) | (is_bulk(kLenb) << 2) |
         (is_bulk(kLenQxx) << 3) | (is_bulk(kLenqx) << 4) | (is_bulk(kLenQuu) << 5) |
         (is_bulk(kLenqu) << 6) | (is_bulk(kLenQux) << 7);
}

// Launches the sweep on `stream` with `spb` scenarios per block; returns the
// CUDA error code (0 on success).  Allocates nothing and does not synchronise.
extern "C" int riccati_backward_launch(
    const float* A, const float* Bm, const float* bv, const float* Qxx,
    const float* qx, const float* Quu, const float* qu, const float* Qux,
    const float* Qf, const float* qf, const float* reg, float* gains,
    float* kff, float* vS, float* vs, float* dv1, float* dv2, int batch, int n,
    int spb, int strict_pivots, void* stream) {
  if (batch <= 0 || n <= 0 || spb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long shared_bytes = static_cast<long long>(spb) * kScenarioBytes;
  if (spb * G > kMaxThreads || shared_bytes > kMaxSharedBytes ||
      (G > 32 && spb > kMaxNamedBarriers)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // Once per device: leave to ask for more than 48 KB of dynamic shared memory.
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(riccati_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = true;
  }
  const int blocks = (batch + spb - 1) / spb;
  riccati_backward_kernel<<<blocks, spb * G, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, bv, Qxx, qx, Quu, qu, Qux, Qf, qf, reg, gains, kff, vS, vs, dv1,
      dv2, batch, n, spb, strict_pivots);
  return static_cast<int>(cudaGetLastError());
}
