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
//   K = -Quu_hat^-1 Qux_hat         kff = -Quu_hat^-1 qu_hat   (Cholesky,
//                                   pivots clamped at sqrt(max(p, 1e-12)))
//   S <- sym(Qxx_hat + K' Quu_hat K + K' Qux_hat + Qux_hat' K)
//   s <- qx_hat + K' Quu_hat kff + K' qu_hat + Qux_hat' kff
//   dv1 += kff . qu_hat             dv2 += 1/2 kff' Quu_hat kff
//
// Design for this card.  The work is bound by bytes: per scenario and node
// it reads 2 nx^2 + 2 nx nu + nu^2 + 2 nx + nu floats and writes
// nx^2 + nx nu + nx + nu floats, against a few thousand operations.  So
// every operand is read from device memory once and every result written
// once, and the value function (S, s) never leaves the SM between nodes: the
// time loop runs INSIDE the kernel (the TPU kernel made time a sequential
// grid axis with (S, s) in scratch memory; blocks of a CUDA grid run in no
// order).
//
// The batch is spread over blocks and threads.  A block takes SB scenarios
// and gives each NT = max(NX, NU) threads, thread (s, j) owning COLUMN j of
// the matrices of scenario s: column j of S A, of Qux_hat, of Qxx_hat and of
// K needs only that thread's registers plus S, A, B of the scenario, which
// live in shared memory (S for the whole sweep).  The small Cholesky of Quu_hat is done by
// the scenario's first thread; every column solve is its own thread's.  One
// thread per scenario would put S (nx = 24: 576 floats) in local memory and
// leave the card with a few thousand threads; here a batch of 4096 gives
// 40,960 threads with the data in registers and shared memory.
//
// Operands are laid out batch-minor, [N, n, m, B]: threadIdx.x is the
// scenario, so a warp reads 32 neighbouring floats (coalesced), and shared
// arrays are [entry][scenario], so a warp's accesses fall in distinct banks.
// The ragged batch edge is masked: threads past the batch repeat the last
// scenario and store nothing.  NX and NU are compile-time constants (one
// library per pair, -DNX= -DNU=); SB follows from the shared memory a block
// may use.
//
// No fast-math: the 1/d and sqrt(max(p, eps)) of the Cholesky match the
// plain version.

#include <cuda_runtime.h>

#ifndef NX
#error "compile with -DNX=<state dim>"
#endif
#ifndef NU
#error "compile with -DNU=<input dim>"
#endif

namespace {

constexpr float kPivotEps = 1e-12f;

// Floats of shared memory per scenario.
constexpr int kSharedPerScenario =
    2 * NX * NX + NX * NU + 2 * NU * NX + 2 * NU * NU + 2 * NX + 3 * NU;

// Threads per scenario: one per column of the widest block.
constexpr int NT = NX > NU ? NX : NU;

// Scenarios per block: as many as fit in 200 KB of shared memory and in
// 1024 threads, at most one warp's width.
constexpr int scenarios_per_block() {
  int sb = 32;
  while (sb > 1 && (sb * kSharedPerScenario * 4 > 200 * 1024 || sb * NT > 1024)) sb /= 2;
  return sb;
}
constexpr int SB = scenarios_per_block();
constexpr int kThreads = SB * NT;
constexpr int kSharedBytes = SB * kSharedPerScenario * 4;

__global__ void __launch_bounds__(kThreads) riccati_backward_kernel(
    const float* __restrict__ A,    // [N, NX, NX, B]
    const float* __restrict__ Bm,   // [N, NX, NU, B]
    const float* __restrict__ bv,   // [N, NX, B]
    const float* __restrict__ Qxx,  // [N, NX, NX, B]
    const float* __restrict__ qx,   // [N, NX, B]
    const float* __restrict__ Quu,  // [N, NU, NU, B]
    const float* __restrict__ qu,   // [N, NU, B]
    const float* __restrict__ Qux,  // [N, NU, NX, B]
    const float* __restrict__ Qf,   // [NX, NX, B]
    const float* __restrict__ qf,   // [NX, B]
    const float* __restrict__ reg,  // [B]
    float* __restrict__ gains,      // [N, NU, NX, B]
    float* __restrict__ kff,        // [N, NU, B]
    float* __restrict__ vS,         // [N+1, NX, NX, B]
    float* __restrict__ vs,         // [N+1, NX, B]
    float* __restrict__ dv1,        // [B]
    float* __restrict__ dv2,        // [B]
    int batch, int n) {
  extern __shared__ float smem[];
  const int s = threadIdx.x;  // scenario within the block
  const int j = threadIdx.y;  // column owned by this thread
  const bool xcol = NT == NX || j < NX;  // owns a column of the nx-wide blocks
  const bool ucol = NT == NU || j < NU;  // owns a column of the nu-wide blocks
  const int jx = xcol ? j : 0;           // a valid column index for idle threads
  const int want = blockIdx.x * SB + s;
  const bool live = want < batch;
  const int sc = live ? want : batch - 1;
  const size_t bs = static_cast<size_t>(batch);

  // Shared arrays, each [entries][SB]; entry e of this scenario at e*SB + s.
  float* S_sh = smem + s;                    // [NX, NX]  value Hessian
  float* AM_sh = S_sh + NX * NX * SB;        // [NX, NX]  A, later M
  float* B_sh = AM_sh + NX * NX * SB;        // [NX, NU]
  float* QUX_sh = B_sh + NX * NU * SB;       // [NU, NX]  Qux_hat
  float* K_sh = QUX_sh + NU * NX * SB;       // [NU, NX]
  float* QUU_sh = K_sh + NU * NX * SB;       // [NU, NU]  Quu_hat
  float* L_sh = QUU_sh + NU * NU * SB;       // [NU, NU]  its Cholesky factor
  float* SV_sh = L_sh + NU * NU * SB;        // [NX]      s + S b
  float* BV_sh = SV_sh + NX * SB;            // [NX]      b
  float* QUH_sh = BV_sh + NX * SB;           // [NU]      qu_hat
  float* KF_sh = QUH_sh + NU * SB;           // [NU]      kff
  float* QUUKF_sh = KF_sh + NU * SB;         // [NU]      Quu_hat kff

  // Terminal value function; node N of the outputs is its copy.
  float s_j = qf[jx * bs + sc];
  if (xcol) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float v = Qf[(i * NX + j) * bs + sc];
      S_sh[(i * NX + j) * SB] = v;
      if (live) vS[(static_cast<size_t>(n) * NX * NX + i * NX + j) * bs + sc] = v;
    }
    if (live) vs[(static_cast<size_t>(n) * NX + j) * bs + sc] = s_j;
  }
  const float r = reg[sc];
  float acc1 = 0.0f, acc2 = 0.0f;  // used by the scenario's first thread
  __syncthreads();

  for (int k = n - 1; k >= 0; --k) {
    const size_t kk = static_cast<size_t>(k);
    const float* A_k = A + kk * NX * NX * bs + sc;
    const float* B_k = Bm + kk * NX * NU * bs + sc;
    const float* Qxx_k = Qxx + kk * NX * NX * bs + sc;
    const float* Quu_k = Quu + kk * NU * NU * bs + sc;
    const float* Qux_k = Qux + kk * NU * NX * bs + sc;

    // -- stage operands into shared memory ---------------------------------
    if (xcol) {
#pragma unroll
      for (int c = 0; c < NX; ++c) AM_sh[(c * NX + j) * SB] = A_k[(c * NX + j) * bs];
      BV_sh[j * SB] = bv[(kk * NX + j) * bs + sc];
    }
    for (int e = j; e < NX * NU; e += NT) B_sh[e * SB] = B_k[e * bs];
    __syncthreads();

    // -- sv_j = s_j + (S b)_j ; columns j of S A and (j < NU) of S B --------
    float sA[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) sA[i] = 0.0f;
    if (xcol) {
      float sv_j = s_j;
#pragma unroll
      for (int c = 0; c < NX; ++c) sv_j += S_sh[(j * NX + c) * SB] * BV_sh[c * SB];
      SV_sh[j * SB] = sv_j;
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const float a_cj = AM_sh[(c * NX + j) * SB];
#pragma unroll
        for (int i = 0; i < NX; ++i) sA[i] += S_sh[(i * NX + c) * SB] * a_cj;
      }
    }
    float sB[NX];
    if (ucol) {
#pragma unroll
      for (int i = 0; i < NX; ++i) sB[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const float b_cj = B_sh[(c * NU + j) * SB];
#pragma unroll
        for (int i = 0; i < NX; ++i) sB[i] += S_sh[(i * NX + c) * SB] * b_cj;
      }
    }
    __syncthreads();  // SV complete

    // -- column j of the hatted blocks -------------------------------------
    float qx_hat_j = qx[(kk * NX + jx) * bs + sc];
#pragma unroll
    for (int c = 0; c < NX; ++c) qx_hat_j += AM_sh[(c * NX + jx) * SB] * SV_sh[c * SB];

    if (ucol) {
      float qu_hat_j = qu[(kk * NU + j) * bs + sc];
#pragma unroll
      for (int c = 0; c < NX; ++c) qu_hat_j += B_sh[(c * NU + j) * SB] * SV_sh[c * SB];
      QUH_sh[j * SB] = qu_hat_j;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = Quu_k[(i * NU + j) * bs];
#pragma unroll
        for (int c = 0; c < NX; ++c) acc += B_sh[(c * NU + i) * SB] * sB[c];
        QUU_sh[(i * NU + j) * SB] = (i == j) ? acc + r : acc;
      }
    }

    float qux[NU];  // Qux_hat[:, j]
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float acc = Qux_k[(i * NX + jx) * bs];
#pragma unroll
      for (int c = 0; c < NX; ++c) acc += B_sh[(c * NU + i) * SB] * sA[c];
      qux[i] = acc;
      if (xcol) QUX_sh[(i * NX + j) * SB] = acc;
    }

    float M[NX];  // Qxx_hat[:, j], later the unsymmetrized S_next[:, j]
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = Qxx_k[(i * NX + jx) * bs];
#pragma unroll
      for (int c = 0; c < NX; ++c) acc += AM_sh[(c * NX + i) * SB] * sA[c];
      M[i] = acc;
    }
    __syncthreads();  // QUU, QUH, QUX complete; A no longer read

    // -- the scenario's first thread: Cholesky, kff, expected decrease ------
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float p = QUU_sh[(c * NU + c) * SB];
#pragma unroll
        for (int m = 0; m < c; ++m) p -= L_sh[(c * NU + m) * SB] * L_sh[(c * NU + m) * SB];
        const float d = sqrtf(fmaxf(p, kPivotEps));
        L_sh[(c * NU + c) * SB] = d;
        const float inv_d = 1.0f / d;
#pragma unroll
        for (int i = c + 1; i < NU; ++i) {
          float q = QUU_sh[(i * NU + c) * SB];
#pragma unroll
          for (int m = 0; m < c; ++m) q -= L_sh[(i * NU + m) * SB] * L_sh[(c * NU + m) * SB];
          L_sh[(i * NU + c) * SB] = q * inv_d;
        }
      }
      float kf[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = QUH_sh[i * SB];
#pragma unroll
        for (int m = 0; m < i; ++m) acc -= L_sh[(i * NU + m) * SB] * kf[m];
        kf[i] = acc / L_sh[(i * NU + i) * SB];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float acc = kf[i];
#pragma unroll
        for (int m = i + 1; m < NU; ++m) acc -= L_sh[(m * NU + i) * SB] * kf[m];
        kf[i] = acc / L_sh[(i * NU + i) * SB];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        kf[i] = -kf[i];
        KF_sh[i * SB] = kf[i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) acc += QUU_sh[(i * NU + c) * SB] * kf[c];
        QUUKF_sh[i * SB] = acc;
        acc1 += kf[i] * QUH_sh[i * SB];
        acc2 += 0.5f * kf[i] * acc;
      }
    }
    __syncthreads();  // L, KF, QUUKF complete

    // -- column j of K = -Quu_hat^-1 Qux_hat, of Quu_hat K, and s_next_j ---
    float Kc[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float acc = qux[i];
#pragma unroll
      for (int m = 0; m < i; ++m) acc -= L_sh[(i * NU + m) * SB] * Kc[m];
      Kc[i] = acc / L_sh[(i * NU + i) * SB];
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
      float acc = Kc[i];
#pragma unroll
      for (int m = i + 1; m < NU; ++m) acc -= L_sh[(m * NU + i) * SB] * Kc[m];
      Kc[i] = acc / L_sh[(i * NU + i) * SB];
    }
    float w[NU];  // (Quu_hat K + Qux_hat)[:, j]
    s_j = qx_hat_j;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      Kc[i] = -Kc[i];
      if (xcol) K_sh[(i * NX + j) * SB] = Kc[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc += QUU_sh[(i * NU + c) * SB] * Kc[c];
      w[i] = acc + qux[i];
      s_j += Kc[i] * (QUUKF_sh[i * SB] + QUH_sh[i * SB]) + qux[i] * KF_sh[i * SB];
    }
    __syncthreads();  // K complete

    // -- M[:, j] += K' (Quu_hat K + Qux_hat)[:, j] + Qux_hat' K[:, j] -------
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = M[i];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        acc += K_sh[(c * NX + i) * SB] * w[c];
        acc += QUX_sh[(c * NX + i) * SB] * Kc[c];
      }
      M[i] = acc;
      if (xcol) AM_sh[(i * NX + j) * SB] = acc;
    }
    __syncthreads();  // M complete

    // -- S <- sym(M); results of node k --------------------------------------
    if (xcol) {
      float* vS_k = vS + kk * NX * NX * bs + sc;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float v = 0.5f * (M[i] + AM_sh[(j * NX + i) * SB]);
        S_sh[(i * NX + j) * SB] = v;
        if (live) vS_k[(i * NX + j) * bs] = v;
      }
      if (live) {
        float* gains_k = gains + kk * NU * NX * bs + sc;
#pragma unroll
        for (int i = 0; i < NU; ++i) gains_k[(i * NX + j) * bs] = Kc[i];
        vs[(kk * NX + j) * bs + sc] = s_j;
      }
    }
    if (live && ucol) kff[(kk * NU + j) * bs + sc] = KF_sh[j * SB];
    __syncthreads();  // S complete; M and KF no longer read
  }
  if (live && j == 0) {
    dv1[sc] = acc1;
    dv2[sc] = acc2;
  }
}

}  // namespace

extern "C" int riccati_backward_nx() { return NX; }
extern "C" int riccati_backward_nu() { return NU; }

// Launches the sweep on `stream`; returns the CUDA error code (0 on
// success).  Allocates nothing and does not synchronise.
extern "C" int riccati_backward_launch(
    const float* A, const float* Bm, const float* bv, const float* Qxx,
    const float* qx, const float* Quu, const float* qu, const float* Qux,
    const float* Qf, const float* qf, const float* reg, float* gains,
    float* kff, float* vS, float* vs, float* dv1, float* dv2, int batch, int n,
    void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      riccati_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(SB, NT);
  const int blocks = (batch + SB - 1) / SB;
  riccati_backward_kernel<<<blocks, block, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, bv, Qxx, qx, Quu, qu, Qux, Qf, qf, reg, gains, kff, vS, vs, dv1,
      dv2, batch, n);
  return static_cast<int>(cudaGetLastError());
}
