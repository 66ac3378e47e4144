// K10: the whole LQ approximation of the legged SRBD problem, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this layer with XLA's
// fusion of `vmap` over `jacfwd` (`approximate_lq`, ocs2_tpu/oc/approx.py).
// The port's generic path (`_approximate_lq_generic` in
// ocs2_tpu_torch/oc/approx.py, `torch.func.vmap` of `jacfwd` and `jacrev`) is
// its plain version; the wrapper is ocs2_tpu_torch/ops/lq_srbd_cuda.py, the
// problems it serves are built by
// ocs2_tpu_torch/models/legged_robot/interface.make_problem (model "srbd",
// projected foot constraint, either friction cone), and
// ocs2_tpu_torch/models/legged_robot/lq_kernel.py hands it the weights and
// constants read from that problem's terms and model.  This file holds the
// functional form only.
//
// Two variants, built from this one source (the template parameter
// kHardCone), differ only in the friction cone's four rows:
//   soft (kHardCone false): the cone is a relaxed barrier in the cost, as
//               below; writes the cost, the dynamics and the foot constraint.
//   hard (kHardCone true):  the cone is the inequality h_c >= 0 (IPM's
//               barrier, solvers/ipm.py); the cost leaves it out, and the
//               kernel writes its linearization besides: ineq f [B, N, 4],
//               dfdu [B, N, 4, 24] and dfdx [B, N, 4, 24], the last exactly
//               zero (the cone reads no state).
//
// What it computes, for node k of scenario b (x = xs[b, k], u = us[b, k],
// dt = t[k+1] - t[k], m = is_jump[k], c_l = bit l of mode[k], one flag a leg):
//   dynamics    F = flow(x, u): one step of rk2 (the explicit midpoint rule)
//               of the SRBD flow, and A = dF/dx, B = dF/du in forward mode;
//               f = (1-m) F + m x,
//               dfdx = (1-m) A + m I, dfdu = (1-m) B (no jump map).
//   cost        dt x [ 1/2 dx'Q dx + 1/2 du'R du  (dx = x - x*(t_k), du = u - u*(t_k))
//                     + sum_l phi_v(h_v,l) + phi_c(h_c,l) + phi_h(h_h,l) ]
//               quadratized in closed form, each penalty term by Gauss-Newton:
//               Hessian J' diag(phi'') J, gradient J' phi', with the rows
//                 h_v,l = (1-c_l)(v_z,l - vz*_k,l)   swing velocity, quadratic
//                 h_c,l = c_l (mu f_z - sqrt(f_x^2 + f_y^2 + eps)) + (1-c_l)
//                                                     friction cone, relaxed barrier
//                                                     (soft only)
//                 h_h,l = (1-c_l)(p_z,l - z*_k,l)    swing height (state only), quadratic
//               and at node N the terminal 1/2 dx'Qf dx (input blocks zero).
//   equality    the foot constraint c_l v_l + (1-c_l) f_l (12 rows) and its
//               Jacobians, for the null-space projection.
//   inequality  (hard only) the rows h_c,l and their Jacobians.
//
// What bounds it.  A node's results are 3,541 floats (14.2 KB; the hard
// variant 196 more) against 48 forward-mode tangents of two SRBD evaluations
// (rk2) and the Gauss-Newton products, some 50,000 operations: at 4,096 x 100
// nodes 5.9 GB to move (6.2 GB hard), 1.76 ms at 3.35 TB/s (1.86 ms hard), and
// 20-40 GFLOP, 0.3-0.6 ms at 67 TFLOP/s.  Bytes bound it, so the design writes
// every result once, coalesced, and reads little.
//
// * One thread per tangent direction of a node: 24 directions of x, then 24
//   of u.  Each thread runs the node's whole evaluation in dual numbers
//   (value, derivative along its direction): the foot kinematics, the
//   constraint rows and the integrator's stages.  Forward mode is what
//   `jacfwd` computes.  The value part is the same in every thread; its one
//   costly piece, the sines and cosines of the model's 15 angles at each
//   state, is computed once: threads 0 ... 14 of the node fill a table in
//   shared memory, one angle each, and a barrier later every thread reads
//   it.  The midpoint's state is the first stage's rates applied to x, so
//   the threads that fill its table already hold its angles.  Two tables
//   alternate; the midpoint costs one barrier.
// * The midpoint is not stored: it is read entry by entry from x, held in
//   shared memory, and the 9 rates of the flow that are not copies of x or
//   u, held in registers, so that the step keeps to 96 registers.
// * A node's columns meet in shared memory (the flow's 24 x 48 Jacobian, the
//   foot constraint's 12 x 48, the twelve penalty rows' 12 x 48), each thread
//   writing its own column, so that after one barrier the 48 threads of the
//   node store every result row by row: thread t writes the quads (4
//   entries, 16 bytes) t, t + 48, ... of each matrix, and a warp's stores
//   fall on consecutive addresses.  The hard variant's cone rows are stored
//   the same way, from the same columns.
// * Four nodes a block (192 threads, 40,128 bytes of static shared memory),
//   three blocks an SM.  Nodes are numbered b (N+1) + k over the whole
//   batch, so a block's nodes are neighbours in memory; node N of a scenario
//   takes the barriers with the others on the last interval's inputs and
//   computes the terminal cost only.
// * The twelve penalty rows' values and derivatives are computed by every
//   thread of the node from the rows' values; the Hessian entry (i, j) of a
//   block sums only the rows whose Jacobian is not zero there (the cone
//   reads no state, the swing height no input), which leaves its value as
//   the generic path's sum of exact zeros leaves it.
//
// FP32, no tensor cores and no fast-math: sinf, cosf, sqrtf, logf and the
// divisions are the precise ones.  The same mathematics as the generic path;
// only the order of rounding differs.
//
// The code before "the kernel and its host interface" is plain C++ (its
// functions are __host__ __device__ under nvcc, K10_SYNC the block's
// barrier): a host build runs each thread of a node as a host thread, with
// a barrier of the node's own for K10_SYNC.

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K10_HD __host__ __device__ __forceinline__
#define K10_UNROLL _Pragma("unroll")
__host__ __device__ __forceinline__ void k10_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}
#define K10_SYNC() k10_sync()
#else
#define K10_HD inline
#define K10_UNROLL
void k10_host_sync();  // a host build's barrier of one node's threads
#define K10_SYNC() k10_host_sync()
#endif

namespace k10 {

constexpr int kNx = 24;
constexpr int kNu = 24;
constexpr int kDirs = kNx + kNu;  // threads of a node
constexpr int kEq = 12;           // foot-constraint rows
constexpr int kRows = 12;         // penalty rows: swing velocity, cone, swing height
constexpr int kVel = 0, kCone = 4, kHeight = 8;
constexpr int kIneq = 4;          // the hard variant's inequality rows: the cone's
constexpr int kAngles = 15;        // yaw, pitch, roll; HAA, HFE, HFE + KFE of each leg
constexpr int kNodesPerBlock = 4;
constexpr int kThreads = kDirs * kNodesPerBlock;

// A node's shared floats: x and u; the tangent columns of the flow, of the
// foot constraint and of the penalty rows (row r, direction j at r * kDirs + j);
// the values of the flow, the constraint and the penalty rows; the tracking
// cost's gradient rows Q dx | R du (or Qf dx at node N); two tables of the
// sines and cosines of the model's 15 angles.
constexpr int kOffXu = 0;
constexpr int kOffDyn = kOffXu + kDirs;
constexpr int kOffEq = kOffDyn + kNx * kDirs;
constexpr int kOffGn = kOffEq + kEq * kDirs;
constexpr int kOffPrim = kOffGn + kRows * kDirs;  // flow 24 | constraint 12 | rows 12
constexpr int kOffTrack = kOffPrim + kNx + kEq + kRows;
constexpr int kOffTrig = kOffTrack + kDirs;
constexpr int kNodeFloats = kOffTrig + 4 * kAngles;

// The weights and constants, in the order of ops/lq_srbd_cuda.CONSTANTS.
struct Constants {
  float mass;
  float gravity[3];
  float inertia[3];
  float hip[4][3];    // HAA mounting points, base frame
  float lateral[4];   // signed HAA-to-leg-plane offsets
  float thigh, shank;
  float cos_floor;    // of the Euler-rate matrix
  float friction_mu, cone_eps;
  float barrier_mu, barrier_delta;
  float height_scale, velocity_scale;
};
constexpr int kNumConstants = static_cast<int>(sizeof(Constants) / sizeof(float));

// Inputs and results; every array contiguous, float32 (modes int32).
struct Args {
  const float* xs;       // [B, N+1, 24]
  const float* us;       // [B, N, 24]
  const float* dt;       // [N]
  const float* is_jump;  // [N]
  const int* modes;      // [N]
  const float* swing_z;  // [N, 4]
  const float* swing_vz; // [N, 4]
  const float* x_ref;    // [N+1, 24], row N the terminal cost's target
  const float* u_ref;    // [N, 24]
  const float* Q;        // [24, 24]
  const float* R;        // [24, 24]
  const float* Qf;       // [24, 24]
  float* cost_f;         // [B, N+1]
  float* cost_dfdx;      // [B, N+1, 24]
  float* cost_dfdu;      // [B, N+1, 24]
  float* cost_dfdxx;     // [B, N+1, 24, 24]
  float* cost_dfdux;     // [B, N+1, 24, 24]
  float* cost_dfduu;     // [B, N+1, 24, 24]
  float* dyn_f;          // [B, N, 24]
  float* dyn_dfdx;       // [B, N, 24, 24]
  float* dyn_dfdu;       // [B, N, 24, 24]
  float* eq_f;           // [B, N, 12]
  float* eq_dfdx;        // [B, N, 12, 24]
  float* eq_dfdu;        // [B, N, 12, 24]
  float* ineq_f;         // [B, N, 4], the hard variant only (else null)
  float* ineq_dfdx;      // [B, N, 4, 24]
  float* ineq_dfdu;      // [B, N, 4, 24]
  int batch, n;
  Constants k;
};

// -- dual numbers: a value and its derivative along the thread's direction --------

struct Dual {
  float v, d;
};
K10_HD Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
K10_HD Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
K10_HD Dual operator-(Dual a) { return {-a.v, -a.d}; }
K10_HD Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
K10_HD Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
K10_HD Dual operator*(Dual a, float s) { return {a.v * s, a.d * s}; }
K10_HD Dual operator+(Dual a, float s) { return {a.v + s, a.d}; }
K10_HD Dual operator+(float s, Dual a) { return {s + a.v, a.d}; }
K10_HD Dual operator-(Dual a, float s) { return {a.v - s, a.d}; }
K10_HD Dual operator/(Dual a, float s) { return {a.v / s, a.d / s}; }
K10_HD Dual operator/(Dual a, Dual b) {
  const float v = a.v / b.v;
  return {v, (a.d - v * b.d) / b.v};
}
K10_HD Dual dsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return {r, a.d / (2.0f * r)};
}
// torch.clamp(a, min=lo): the derivative passes where a >= lo; NaN stays NaN.
K10_HD Dual dclamp_min(Dual a, float lo) { return a.v < lo ? Dual{lo, 0.0f} : a; }

// An input vector held in shared memory, seen as duals: entry `dir` carries
// the derivative 1, every other 0.
struct Seeded {
  const float* v;
  int dir;
  K10_HD Dual operator[](int i) const { return {v[i], i == dir ? 1.0f : 0.0f}; }
};

// -- the model (models/legged_robot/model.py) -------------------------------------------

// The model's angles (kAngles): yaw, pitch, roll, then for each leg HAA, HFE
// and HFE + KFE.  Their sines and cosines at a state are the same in every
// thread of a node: threads 0 ... 14 compute them once into a table in
// shared memory, and every thread's dual numbers read them there.

template <class X>
K10_HD float angle(const X& x, int a) {
  if (a < 3) return x[9 + a].v;
  const int joint = 12 + 3 * ((a - 3) / 3), which = (a - 3) % 3;
  return which < 2 ? x[joint + which].v : (x[joint + 1] + x[joint + 2]).v;
}

// Thread t < kAngles: sin and cos of angle t of state x into the table.
template <class X>
K10_HD void fill_trig(float* table, const X& x, int t) {
  if (t < kAngles) {
    const float a = angle(x, t);
    table[2 * t] = sinf(a);
    table[2 * t + 1] = cosf(a);
  }
}

// sin and cos of angle `a` (whose dual is `x`) from the table.
struct Trig {
  const float* table;
  K10_HD Dual sin(int a, Dual x) const { return {table[2 * a], table[2 * a + 1] * x.d}; }
  K10_HD Dual cos(int a, Dual x) const { return {table[2 * a + 1], -table[2 * a] * x.d}; }
};

// Rz(yaw) Ry(pitch) Rx(roll) of the state's euler angles (x[9:12]).
template <class X>
K10_HD void rotation(const Trig& tr, const X& x, Dual r[3][3]) {
  const Dual yaw = x[9], pitch = x[10], roll = x[11];
  const Dual cy = tr.cos(0, yaw), sy = tr.sin(0, yaw), cp = tr.cos(1, pitch);
  const Dual sp = tr.sin(1, pitch), cr = tr.cos(2, roll), sr = tr.sin(2, roll);
  r[0][0] = cy * cp;
  r[0][1] = cy * sp * sr - sy * cr;
  r[0][2] = cy * sp * cr + sy * sr;
  r[1][0] = sy * cp;
  r[1][1] = sy * sp * sr + cy * cr;
  r[1][2] = sy * sp * cr - cy * sr;
  r[2][0] = -sp;
  r[2][1] = cp * sr;
  r[2][2] = cp * cr;
}

K10_HD void rotate(const Dual r[3][3], const Dual v[3], Dual out[3]) {
  K10_UNROLL
  for (int i = 0; i < 3; ++i) out[i] = r[i][0] * v[0] + r[i][1] * v[1] + r[i][2] * v[2];
}

K10_HD void cross(const Dual a[3], const Dual b[3], Dual out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// One leg's sagittal-plane foot position after HFE and KFE, its derivatives
// with respect to KFE, and the HAA rotation's cosine and sine.
struct Leg {
  Dual xp, zp, dx_dkfe, dz_dkfe, c, s;
};

template <class X>
K10_HD Leg leg_plane(const Constants& k, const Trig& tr, const X& x, int leg) {
  const int a = 3 + 3 * leg, j = 12 + 3 * leg;
  const Dual haa = x[j], hfe = x[j + 1];
  const Dual h12 = hfe + x[j + 2];
  const Dual s1 = tr.sin(a + 1, hfe), c1 = tr.cos(a + 1, hfe);
  const Dual s12 = tr.sin(a + 2, h12), c12 = tr.cos(a + 2, h12);
  Leg g;
  g.xp = (-k.thigh) * s1 - k.shank * s12;
  g.zp = (-k.thigh) * c1 - k.shank * c12;
  g.dx_dkfe = (-k.shank) * c12;
  g.dz_dkfe = k.shank * s12;
  g.c = tr.cos(a, haa);
  g.s = tr.sin(a, haa);
  return g;
}

// Foot position in the base frame.
K10_HD void foot_base(const Constants& k, int leg, const Leg& g, Dual p[3]) {
  const float lat = k.lateral[leg];
  p[0] = k.hip[leg][0] + g.xp;
  p[1] = k.hip[leg][1] + (g.c * lat - g.s * g.zp);
  p[2] = k.hip[leg][2] + (g.s * lat + g.c * g.zp);
}

// The leg Jacobian times the joint velocities dq, in the base frame.
K10_HD void foot_velocity_base(const Constants& k, int leg, const Leg& g, Dual dhaa,
                               Dual dhfe, Dual dkfe, Dual v[3]) {
  const float lat = k.lateral[leg];
  const Dual vzp = (-g.xp) * dhfe + g.dz_dkfe * dkfe;
  v[0] = g.zp * dhfe + g.dx_dkfe * dkfe;
  v[1] = ((-g.s) * lat - g.c * g.zp) * dhaa - g.s * vzp;
  v[2] = (g.c * lat - g.s * g.zp) * dhaa + g.c * vzp;
}

template <class X>
K10_HD void body_angular_velocity(const Constants& k, const X& x, Dual w[3]) {
  K10_UNROLL
  for (int i = 0; i < 3; ++i) w[i] = (k.mass * x[3 + i]) / k.inertia[i];
}

// The SRBD flow dx/dt = f(x, u) (model.dynamics) is [dv, dh, x[0:3], de,
// u[12:24]]; `Rates` holds the three parts that are not copies.
struct Rates {
  Dual dv[3], dh[3], de[3];
};

template <class X, class In>
K10_HD Rates srbd_rates(const Constants& k, const Trig& tr, const X& x, const In& u) {
  Dual r[3][3];
  rotation(tr, x, r);
  Dual force[3] = {u[0], u[1], u[2]};
  Dual torque[3];
  K10_UNROLL
  for (int leg = 0; leg < 4; ++leg) {
    const Leg g = leg_plane(k, tr, x, leg);
    Dual pb[3], lever[3], tau[3];
    foot_base(k, leg, g, pb);
    rotate(r, pb, lever);
    const Dual f[3] = {u[3 * leg], u[3 * leg + 1], u[3 * leg + 2]};
    cross(lever, f, tau);
    K10_UNROLL
    for (int i = 0; i < 3; ++i) {
      if (leg > 0) force[i] = force[i] + f[i];
      torque[i] = leg > 0 ? torque[i] + tau[i] : tau[i];
    }
  }
  Dual w[3];
  body_angular_velocity(k, x, w);
  const Dual pitch = x[10], roll = x[11];
  const Dual cp = dclamp_min(tr.cos(1, pitch), k.cos_floor);
  const Dual sp = tr.sin(1, pitch), cr = tr.cos(2, roll), sr = tr.sin(2, roll);
  Rates out;
  K10_UNROLL
  for (int i = 0; i < 3; ++i) {
    out.dv[i] = force[i] / k.mass - k.gravity[i];
    out.dh[i] = torque[i] / k.mass;
  }
  // The Euler-rate matrix [[0, sr/cp, cr/cp], [0, cr, -sr], [1, sr sp/cp, cr sp/cp]] times w.
  out.de[0] = (sr / cp) * w[1] + (cr / cp) * w[2];
  out.de[1] = cr * w[1] + (-sr) * w[2];
  out.de[2] = w[0] + ((sr * sp) / cp) * w[1] + ((cr * sp) / cp) * w[2];
  return out;
}

// Entry i of the flow at (x, u), from its rates.
template <class X, class In>
K10_HD Dual rate(const Rates& r, const X& x, const In& u, int i) {
  if (i < 3) return r.dv[i];
  if (i < 6) return r.dh[i - 3];
  if (i < 9) return x[i - 6];
  if (i < 12) return r.de[i - 9];
  return u[i];
}

// The midpoint of the step, x + c k, where k is the flow at x from its rates
// r.  It holds no array: entry i is formed when it is read, from x and r,
// so that the step keeps only the rates of its stages (9 duals each) and
// not the midpoint's state (24).
template <class X, class In>
struct Midpoint {
  const X& x;
  const In& u;
  const Rates& r;
  float c;
  K10_HD Dual operator[](int i) const { return x[i] + c * rate(r, x, u, i); }
};

// The tables of sines and cosines of a node's states, two in turn: x's own
// and the midpoint's, which threads 0 ... 14 fill while the others may
// still read x's; a barrier makes the midpoint's current.
struct Tables {
  float* base;  // two tables of 2 kAngles floats
  int t;        // the thread's direction
  int cur;
  K10_HD Trig now() const { return {base + cur * 2 * kAngles}; }
  template <class X>
  K10_HD void advance(const X& next) {
    fill_trig(base + (1 - cur) * 2 * kAngles, next, t);
    K10_SYNC();
    cur = 1 - cur;
  }
};

// One rk2 step over h from x (core/integrate.rk2_step, the discretization
// of core/integrate.discretize in one step), x's table current;
// emit(i, x_next[i]) receives the result.
template <class X, class In, class Emit>
K10_HD void rk2_step(const Constants& k, Tables& tb, float h, const X& x, const In& u,
                     Emit emit) {
  const Rates r1 = srbd_rates(k, tb.now(), x, u);
  const Midpoint<X, In> mid{x, u, r1, 0.5f * h};
  tb.advance(mid);
  const Rates r2 = srbd_rates(k, tb.now(), mid, u);
  K10_UNROLL
  for (int i = 0; i < kNx; ++i) emit(i, x[i] + h * rate(r2, mid, u, i));
}

// The foot constraint's 12 rows and the 12 penalty rows at (x, u)
// (constraints.py: foot_constraint, swing_normal_velocity, friction_cone,
// swing height).
template <class X, class In>
K10_HD void constraint_rows(const Constants& k, const Trig& tr, const X& x, const In& u,
                            int mode, const float* z_ref, const float* vz_ref, Dual eq[kEq],
                            Dual rows[kRows]) {
  Dual r[3][3], w[3];
  rotation(tr, x, r);
  body_angular_velocity(k, x, w);
  K10_UNROLL
  for (int leg = 0; leg < 4; ++leg) {
    const float c = static_cast<float>((mode >> leg) & 1);
    const Leg g = leg_plane(k, tr, x, leg);
    Dual pb[3], lever[3], vb[3], rvb[3], wl[3];
    foot_base(k, leg, g, pb);
    rotate(r, pb, lever);
    foot_velocity_base(k, leg, g, u[12 + 3 * leg], u[13 + 3 * leg], u[14 + 3 * leg], vb);
    rotate(r, vb, rvb);
    cross(w, lever, wl);
    Dual v[3];
    K10_UNROLL
    for (int i = 0; i < 3; ++i) {
      v[i] = (x[i] + wl[i]) + rvb[i];
      eq[3 * leg + i] = c * v[i] + (1.0f - c) * u[3 * leg + i];
    }
    const Dual fx = u[3 * leg], fy = u[3 * leg + 1], fz = u[3 * leg + 2];
    const Dual cone = k.friction_mu * fz - dsqrt(fx * fx + fy * fy + k.cone_eps);
    rows[kVel + leg] = (1.0f - c) * (v[2] - vz_ref[leg]);
    rows[kCone + leg] = c * cone + (1.0f - c) * 1.0f;
    rows[kHeight + leg] = (1.0f - c) * ((x[8] + lever[2]) - z_ref[leg]);
  }
}

// A penalty's value and first and second derivatives at h (core/penalties.py).
struct Penalty {
  float value, first, second;
};

K10_HD Penalty quadratic(float scale, float h) {
  return {0.5f * scale * (h * h), scale * h, scale};
}

// The relaxed barrier: -mu ln h above delta, its quadratic extension below.
K10_HD Penalty relaxed_barrier(float mu, float delta, float h) {
  if (h > delta) return {-mu * logf(h), -mu / h, mu / (h * h)};
  const float a = (h - 2.0f * delta) / delta;
  return {mu * (0.5f * (a * a) - 0.5f - logf(delta)), mu * a / delta, mu / (delta * delta)};
}

K10_HD Penalty row_penalty(const Constants& k, int row, float h) {
  if (row < kCone) return quadratic(k.velocity_scale, h);
  if (row < kHeight) return relaxed_barrier(k.barrier_mu, k.barrier_delta, h);
  return quadratic(k.height_scale, h);
}

// -- a node's program ------------------------------------------------------------------

struct Node {
  int b, k;  // scenario, node
  bool terminal;
};

K10_HD Node node_of(const Args& a, long long index) {
  const int b = static_cast<int>(index / (a.n + 1));
  const int k = static_cast<int>(index - static_cast<long long>(b) * (a.n + 1));
  return {b, k, k == a.n};
}

// x and u of the node in shared memory (thread t stages entry t of x | u;
// node N has no input and stages zeros).
K10_HD void stage(const Args& a, const Node& nd, int t, float* sm) {
  if (t < kNx) {
    sm[kOffXu + t] = a.xs[(static_cast<long long>(nd.b) * (a.n + 1) + nd.k) * kNx + t];
  } else {
    sm[kOffXu + t] = nd.terminal
        ? 0.0f : a.us[(static_cast<long long>(nd.b) * a.n + nd.k) * kNu + (t - kNx)];
  }
}

// Direction t's tangent columns and (t = 0) the values; x's table current.
// Node N takes the step's barrier with the others of its block, on the last
// interval's inputs, and keeps only its tracking row.
K10_HD void tangents(const Args& a, const Node& nd, int t, float* sm, Tables& tb) {
  const float* xu = sm + kOffXu;
  const float* x_ref = a.x_ref + nd.k * kNx;
  const int k = nd.terminal ? a.n - 1 : nd.k;  // the node inputs read
  // The tracking cost's gradient row t: (Q dx)_t or (R du)_{t-24}; (Qf dx)_t at node N.
  if (t < kNx) {
    const float* w = nd.terminal ? a.Qf : a.Q;
    float q = 0.0f;
    for (int j = 0; j < kNx; ++j) q += w[t * kNx + j] * (xu[j] - x_ref[j]);
    sm[kOffTrack + t] = q;
  } else if (!nd.terminal) {
    const float* u_ref = a.u_ref + nd.k * kNu;
    float q = 0.0f;
    for (int j = 0; j < kNu; ++j) q += a.R[(t - kNx) * kNu + j] * (xu[kNx + j] - u_ref[j]);
    sm[kOffTrack + t] = q;
  }

  const Seeded x{xu, t};
  const Seeded u{xu + kNx, t - kNx};
  if (!nd.terminal) {
    Dual eq[kEq], rows[kRows];
    constraint_rows(a.k, tb.now(), x, u, a.modes[k], a.swing_z + 4 * k, a.swing_vz + 4 * k,
                    eq, rows);
    K10_UNROLL
    for (int r = 0; r < kEq; ++r) sm[kOffEq + r * kDirs + t] = eq[r].d;
    K10_UNROLL
    for (int r = 0; r < kRows; ++r) sm[kOffGn + r * kDirs + t] = rows[r].d;
    if (t == 0) {
      for (int r = 0; r < kEq; ++r) sm[kOffPrim + kNx + r] = eq[r].v;
      for (int r = 0; r < kRows; ++r) sm[kOffPrim + kNx + kEq + r] = rows[r].v;
    }
  }
  rk2_step(a.k, tb, a.dt[k], x, u, [&](int i, Dual v) {
    sm[kOffDyn + i * kDirs + t] = v.d;
    if (t == 0) sm[kOffPrim + i] = v.v;
  });
}

// Four consecutive floats at a multiple of 16 bytes, in one access on the card.
struct F4 {
  float v[4];
};
K10_HD F4 load4(const float* p) {
#ifdef __CUDACC__
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{p[0], p[1], p[2], p[3]}};
#endif
}
K10_HD void store4(float* p, const F4& f) {
#ifdef __CUDACC__
  *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
#else
  for (int c = 0; c < 4; ++c) p[c] = f.v[c];
#endif
}

// Phase 2, thread t: the node's results, each matrix by quads of entries
// t, t + 48, ... (a quad is 4 entries of one row).  kHardCone: the cone's
// rows are an inequality, stored as such; their penalty reads zero, so they
// add exact zeros to the cost's sums, and their Hessian sums are skipped.
template <bool kHardCone>
K10_HD void results(const Args& a, const Node& nd, int t, const float* sm) {
  const float* xu = sm + kOffXu;
  const float* track = sm + kOffTrack;
  const long long c = static_cast<long long>(nd.b) * (a.n + 1) + nd.k;  // cost node
  float* Qxx = a.cost_dfdxx + c * kNx * kNx;
  float* Qux = a.cost_dfdux + c * kNu * kNx;
  float* Quu = a.cost_dfduu + c * kNu * kNu;
  if (nd.terminal) {
    const float* x_ref = a.x_ref + nd.k * kNx;
    if (t < kNx) {
      a.cost_dfdx[c * kNx + t] = track[t];
    } else {
      a.cost_dfdu[c * kNu + (t - kNx)] = 0.0f;
    }
    if (t == 0) {
      float f = 0.0f;
      for (int i = 0; i < kNx; ++i) f += (xu[i] - x_ref[i]) * track[i];
      a.cost_f[c] = 0.5f * f;
    }
    const F4 zero = {{0.0f, 0.0f, 0.0f, 0.0f}};
    for (int e = 4 * t; e < kNx * kNx; e += 4 * kDirs) {
      F4 qf;
      K10_UNROLL
      for (int q = 0; q < 4; ++q) qf.v[q] = a.Qf[e + q];
      store4(Qxx + e, qf);
      store4(Qux + e, zero);
      store4(Quu + e, zero);
    }
    return;
  }

  const long long g = static_cast<long long>(nd.b) * a.n + nd.k;  // interval node
  const float dt = a.dt[nd.k];
  const float m = a.is_jump[nd.k];
  const float* prim = sm + kOffPrim;
  const float* dyn = sm + kOffDyn;
  const float* eqj = sm + kOffEq;
  const float* jac = sm + kOffGn;
  float first[kRows], second[kRows], value[kRows];
  K10_UNROLL
  for (int r = 0; r < kRows; ++r) {
    if (kHardCone && r >= kCone && r < kHeight) {  // no penalty
      value[r] = first[r] = second[r] = 0.0f;
      continue;
    }
    const Penalty p = row_penalty(a.k, r, prim[kNx + kEq + r]);
    value[r] = p.value;
    first[r] = p.first;
    second[r] = p.second;
  }

  float* A = a.dyn_dfdx + g * kNx * kNx;
  float* B = a.dyn_dfdu + g * kNx * kNu;
  for (int e = 4 * t; e < kNx * kNx; e += 4 * kDirs) {
    const int i = e / kNx, j = e % kNx;
    // Dynamics: the mask blends in the jump (the identity map).
    const F4 ax = load4(dyn + i * kDirs + j), bu = load4(dyn + i * kDirs + kNx + j);
    F4 Ae, Be;
    K10_UNROLL
    for (int q = 0; q < 4; ++q) {
      Ae.v[q] = (1.0f - m) * ax.v[q] + m * (i == j + q ? 1.0f : 0.0f);
      Be.v[q] = (1.0f - m) * bu.v[q];
    }
    store4(A + e, Ae);
    store4(B + e, Be);

    // Hessian blocks: dt (W + J' diag(phi'') J), each term summed as the
    // generic path sums its terms (tracking, swing velocity, cone, height).
    F4 vel_xx = {}, vel_ux = {}, vel_uu = {}, cone_uu = {}, height_xx = {};
    K10_UNROLL
    for (int r = kVel; r < kVel + 4; ++r) {
      const float* row = jac + r * kDirs;
      const float wi = row[i] * second[r], wui = row[kNx + i] * second[r];
      const F4 rj = load4(row + j), ruj = load4(row + kNx + j);
      K10_UNROLL
      for (int q = 0; q < 4; ++q) {
        vel_xx.v[q] += wi * rj.v[q];
        vel_ux.v[q] += wui * rj.v[q];
        vel_uu.v[q] += wui * ruj.v[q];
      }
    }
    if constexpr (!kHardCone) {
      K10_UNROLL
      for (int r = kCone; r < kCone + 4; ++r) {
        const float* row = jac + r * kDirs;
        const float wui = row[kNx + i] * second[r];
        const F4 ruj = load4(row + kNx + j);
        K10_UNROLL
        for (int q = 0; q < 4; ++q) cone_uu.v[q] += wui * ruj.v[q];
      }
    }
    K10_UNROLL
    for (int r = kHeight; r < kHeight + 4; ++r) {
      const float* row = jac + r * kDirs;
      const float wi = row[i] * second[r];
      const F4 rj = load4(row + j);
      K10_UNROLL
      for (int q = 0; q < 4; ++q) height_xx.v[q] += wi * rj.v[q];
    }
    F4 xx, ux, uu;
    K10_UNROLL
    for (int q = 0; q < 4; ++q) {
      xx.v[q] = (dt * a.Q[e + q] + dt * vel_xx.v[q]) + dt * height_xx.v[q];
      ux.v[q] = dt * vel_ux.v[q];
      uu.v[q] = (dt * a.R[e + q] + dt * vel_uu.v[q]) + dt * cone_uu.v[q];
    }
    store4(Qxx + e, xx);
    store4(Qux + e, ux);
    store4(Quu + e, uu);
  }
  if (t < kNx) a.dyn_f[g * kNx + t] = (1.0f - m) * prim[t] + m * xu[t];

  // The foot constraint.
  if (t < kEq) a.eq_f[g * kEq + t] = prim[kNx + t];
  for (int e = 4 * t; e < kEq * kNx; e += 4 * kDirs) {
    const int i = e / kNx, j = e % kNx;
    store4(a.eq_dfdx + g * kEq * kNx + e, load4(eqj + i * kDirs + j));
    store4(a.eq_dfdu + g * kEq * kNu + e, load4(eqj + i * kDirs + kNx + j));
  }

  // The hard cone: its rows, their input Jacobian, and a state Jacobian of zeros.
  if constexpr (kHardCone) {
    if (t < kIneq) a.ineq_f[g * kIneq + t] = prim[kNx + kEq + kCone + t];
    const F4 zero = {{0.0f, 0.0f, 0.0f, 0.0f}};
    for (int e = 4 * t; e < kIneq * kNu; e += 4 * kDirs) {
      const int i = e / kNu, j = e % kNu;
      store4(a.ineq_dfdu + g * kIneq * kNu + e, load4(jac + (kCone + i) * kDirs + kNx + j));
      store4(a.ineq_dfdx + g * kIneq * kNx + e, zero);
    }
  }

  // Gradient row t (x, then u).
  float vel = 0.0f, other = 0.0f;
  K10_UNROLL
  for (int r = kVel; r < kVel + 4; ++r) vel += jac[r * kDirs + t] * first[r];
  const int other_rows = t < kNx ? kHeight : kCone;
  K10_UNROLL
  for (int r = 0; r < 4; ++r) {
    const float phi = t < kNx ? first[kHeight + r] : first[kCone + r];
    other += jac[(other_rows + r) * kDirs + t] * phi;
  }
  const float grad = (dt * track[t] + dt * vel) + dt * other;
  if (t < kNx) {
    a.cost_dfdx[c * kNx + t] = grad;
  } else {
    a.cost_dfdu[c * kNu + (t - kNx)] = grad;
  }

  if (t == 0) {
    const float* x_ref = a.x_ref + nd.k * kNx;
    const float* u_ref = a.u_ref + nd.k * kNu;
    float fx = 0.0f, fu = 0.0f;
    for (int i = 0; i < kNx; ++i) fx += (xu[i] - x_ref[i]) * track[i];
    for (int i = 0; i < kNu; ++i) fu += (xu[kNx + i] - u_ref[i]) * track[kNx + i];
    float sums[3] = {0.0f, 0.0f, 0.0f};  // swing velocity, cone, height
    K10_UNROLL
    for (int r = 0; r < kRows; ++r) sums[r / 4] += value[r];
    a.cost_f[c] = ((dt * (0.5f * fx + 0.5f * fu) + dt * sums[0]) + dt * sums[1]) + dt * sums[2];
  }
}

// A node's whole program, thread t; every thread of a block meets every
// barrier, a slot past the batch (live false) on node 0, writing nothing.
template <bool kHardCone>
K10_HD void node_program(const Args& a, const Node& nd, bool live, int t, float* sm) {
  stage(a, nd, t, sm);
  K10_SYNC();
  Tables tb{sm + kOffTrig, t, 0};
  fill_trig(tb.base, Seeded{sm + kOffXu, t}, t);
  K10_SYNC();
  tangents(a, nd, t, sm, tb);
  K10_SYNC();
  if (live) results<kHardCone>(a, nd, t, sm);
}

}  // namespace k10

#ifdef __CUDACC__
// -- the kernel and its host interface -------------------------------------------------------

namespace {

// Three blocks an SM: 96 registers a thread (52 bytes spilled to the L1), in
// either variant.  At (4096, 100) on an H100 the soft variant ran in 6.7 ms,
// against 8.4 ms at two blocks (128 registers) and 7.3 ms at four (80, more
// spills); the hard one, which skips the cone's Hessian sums, in 5.9 ms where
// the soft one took 6.3 in the same run.
template <bool kHardCone>
__global__ void __launch_bounds__(k10::kThreads, 3) lq_srbd_kernel(const k10::Args a) {
  __shared__ __align__(16) float smem[k10::kNodesPerBlock * k10::kNodeFloats];
  const int slot = threadIdx.x / k10::kDirs;
  const long long index = static_cast<long long>(blockIdx.x) * k10::kNodesPerBlock + slot;
  const bool live = index < static_cast<long long>(a.batch) * (a.n + 1);
  k10::node_program<kHardCone>(a, k10::node_of(a, live ? index : 0), live,
                               threadIdx.x % k10::kDirs, smem + slot * k10::kNodeFloats);
}

}  // namespace

extern "C" int lq_srbd_num_constants() { return k10::kNumConstants; }
extern "C" int lq_srbd_nodes_per_block() { return k10::kNodesPerBlock; }
extern "C" int lq_srbd_threads_per_block() { return k10::kThreads; }

// Launches K10 on `stream`: the hard variant where the three ineq arrays
// are given, the soft one where all three are null.  Returns the CUDA error
// code (0 on success).  Allocates nothing and does not synchronise.
// `constants` is a host array of lq_srbd_num_constants() floats.
extern "C" int lq_srbd_launch(
    const float* xs, const float* us, const float* dt, const float* is_jump, const int* modes,
    const float* swing_z, const float* swing_vz, const float* x_ref, const float* u_ref,
    const float* Q, const float* R, const float* Qf, float* cost_f, float* cost_dfdx,
    float* cost_dfdu, float* cost_dfdxx, float* cost_dfdux, float* cost_dfduu, float* dyn_f,
    float* dyn_dfdx, float* dyn_dfdu, float* eq_f, float* eq_dfdx, float* eq_dfdu,
    float* ineq_f, float* ineq_dfdx, float* ineq_dfdu, int batch, int n,
    const float* constants, int num_constants, void* stream) {
  const bool hard = ineq_f != nullptr;
  if (batch <= 0 || n <= 0 || num_constants != k10::kNumConstants ||
      (ineq_dfdx != nullptr) != hard || (ineq_dfdu != nullptr) != hard) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  k10::Args a{xs, us, dt, is_jump, modes, swing_z, swing_vz, x_ref, u_ref, Q, R, Qf,
              cost_f, cost_dfdx, cost_dfdu, cost_dfdxx, cost_dfdux, cost_dfduu,
              dyn_f, dyn_dfdx, dyn_dfdu, eq_f, eq_dfdx, eq_dfdu, ineq_f, ineq_dfdx, ineq_dfdu,
              batch, n, {}};
  float* dst = reinterpret_cast<float*>(&a.k);
  for (int i = 0; i < k10::kNumConstants; ++i) dst[i] = constants[i];
  const long long nodes = static_cast<long long>(batch) * (n + 1);
  const long long blocks = (nodes + k10::kNodesPerBlock - 1) / k10::kNodesPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto grid = static_cast<unsigned>(blocks);
  const auto on = static_cast<cudaStream_t>(stream);
  if (hard) {
    lq_srbd_kernel<true><<<grid, k10::kThreads, 0, on>>>(a);
  } else {
    lq_srbd_kernel<false><<<grid, k10::kThreads, 0, on>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
