// Re-anchoring RK4 rollout of the 6-DoF quaternion rocket and the exact
// Jacobians of each of its renormalised steps, for a batch of lanes, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses the rollout's scan and vmap(jacfwd(F)) over the knots. Eager PyTorch
// runs it as a Python loop of RK4 steps and then torch.func's jacfwd: ~7,900
// launches a cycle on the 6-DoF GP-MPC path (Path D: 20 knots, 512 lanes).
// This kernel does the same work in one launch. It shares no code with
// rollout_linearize.cu (the 3-DoF rocket): the state, the live tangent
// columns, the staging and the register budget all differ.
//
// For every lane b, from x_0 = x0[b], and every knot k = 0 … N−1:
//
//     F_k             = step of rocket6dof.py: RK4 of f from x_k under
//                       u_k = U[b,k], then the quaternion renormalised
//     [A_k | B_k]     = ∂F/∂[x, u] at (x_k, u_k)
//     c_k             = F_k − A_k x_k − B_k u_k
//     x_{k+1}         = F_k + rdt·tape[b,k]       (F_k where no tape is given)
//
// Outputs X (B,N+1,14) = [x_0 … x_N], A (B,N,14,14), B (B,N,14,3),
// c (B,N,14), all row-major. State x = [m, r(3), v(3), q(4, scalar first),
// ω(3)], control u = T_B(3). float32 throughout, with f's formula in full
// (rocket6dof.py::f) and its ε guards:
//
//     ṁ = −α‖u‖_ε,  ṙ = v,  v̇ = C (u + F_A)/m + g,
//     q̇ = ½ [−ω·q_v ; q_w ω + ω × q_v],
//     ω̇ = J⁻¹ (r_T × u + r_cp × F_A − ω × J ω),
//     F_A = −½ρS (C_A Cᵀv) ‖v‖_ε,  ‖w‖_ε = sqrt(w·w + ε²),
//
// with C = C_IB(q) in its algebraic form (q is not normalised inside f).
// The step's renormalisation q̂ = q̃/‖q̃‖ enters the tangent as
// dq̂ = (I − q̂q̂ᵀ) dq̃/‖q̃‖.
//
// Thread mapping. A block takes 8 lanes and has 14 × 8 threads: thread
// (col, lane) = (t / 8, t % 8) carries tangent column col for its lane and
// computes the lane's primal chain itself, so that no thread waits on
// another inside a knot. The live columns are ∂/∂m, ∂/∂v (3), ∂/∂q (4),
// ∂/∂ω (3) and ∂/∂u (3): the position columns of A are e_j exactly (f does
// not read r, and jacfwd carries its zeros exactly), staged once and never
// computed. A thread holds the primal (14 states, the stage point, the RK4
// sum) and one tangent of each: 194 registers, no spills. The column is not
// warp-uniform (a warp holds four columns of 8 lanes), but nothing branches
// on it: it only selects the seed of the tangent and where the column is
// staged.
//
// Stores. Each knot's A_k, B_k, F_k, x_k, u_k and x_{k+1} of the block's
// lanes are staged in shared memory, double-buffered (2 × 8 × 283 floats,
// 18 KB). After the knot's one barrier every thread writes its share of the
// staged knot out, consecutive threads on consecutive addresses of one
// lane's contiguous A_k (196 floats), B_k (42), c_k (14) and x_{k+1} (14),
// and then computes the next knot into the other buffer. c_k is formed from
// the staged row (F_i minus the products by one fused multiply-add each,
// the diagonal A_ii x_i first: F_i ≈ x_i, and that cancellation is then
// exact).
//
// Arithmetic. Each stage divides once by m and by ‖v‖_ε, each knot once by
// ‖u‖_ε and by ‖q̃‖, and multiplies by the reciprocals.
//
// Bound on an NVIDIA H100 (3.35 TB/s, 67 TFLOP/s f32): bytes, barely. A lane
// reads 1,416 bytes (x0, U, the tape) and writes 21,336 (N = 20), ~3.5 µs at
// 512 lanes; its ~428 kFLOP (ops/kernels/rollout_linearize.py
// ::_KERNELS) take ~3.3 µs. A block's chain of knots sets the time, as
// in the 3-DoF kernel: each thread runs the primal and one tangent, ~2,400
// operations a knot, in order. So fewer threads an SM run faster, and lanes
// a block trade against the SMs that are busy. Measured (H100 80GB HBM3,
// 700 W, CUDA-graph replays at 512 lanes, 20 knots, the tape): 8 lanes a
// block (64 blocks) 0.0715 ms; 16 (32 blocks, 36 KB staged) 0.0788 ms; 32
// (16 blocks of 448 threads, 72 KB of dynamic shared memory, the register
// budget cut to 128 with 296 bytes of spills) 0.164 ms. The next knot's u
// and tape are loaded a knot ahead. The launch runs on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kNx = 14;
constexpr int kNu = 3;
constexpr int kCols = 14;  // live tangent columns: m, v(3), q(4), ω(3), u(3)
constexpr int kLanes = 8;  // lanes a block
constexpr int kThreads = kLanes * kCols;
// a lane's staged knot: A_k, B_k, F_k, x_k, u_k, x_{k+1}
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kNx * kNx;
constexpr int kOffF = kOffB + kNx * kNu;
constexpr int kOffX = kOffF + kNx;
constexpr int kOffU = kOffX + kNx;
constexpr int kOffN = kOffU + kNu;
constexpr int kStride = kOffN + kNx;  // 283, odd: a lane's rows on distinct banks
static_assert(kStride % 2 == 1, "the staging stride must be odd");
constexpr int kBuffer = kLanes * kStride;

struct Model {
  float alpha;     // 1/(I_sp g0)
  float eps2;      // ε² of the ‖u‖ and ‖v‖ guards
  float ka;        // ½ ρ S_ref
  float g[3];      // g_I
  float rT[3];     // r_T_B
  float rcp[3];    // r_cp_B
  float J[9];      // J_B, row-major
  float Ji[9];     // J_B⁻¹
  float CA[9];     // C_A
  float h2;        // dt/2 of the RK4 step
  float h;         // dt
  float h6;        // dt/6
  float rdt;       // the time step the residual tape is scaled by
};
constexpr int kModelFloats = 43;
static_assert(sizeof(Model) == kModelFloats * sizeof(float), "Model is a packed float array");

__device__ __forceinline__ void mat3(const float M[9], const float a0, const float a1,
                                     const float a2, float out[3]) {
  out[0] = M[0] * a0 + M[1] * a1 + M[2] * a2;
  out[1] = M[3] * a0 + M[4] * a1 + M[5] * a2;
  out[2] = M[6] * a0 + M[7] * a1 + M[8] * a2;
}

// f(z, u) into k, and its derivative along (dz, du) into dk; du is a unit
// vector or zero. rT = 1/‖u‖_ε, the same at every stage.
__device__ __forceinline__ void f_jvp(const Model& p, const float z[kNx], const float dz[kNx],
                                      const float u[kNu], const float du[kNu], float T, float rT,
                                      float k[kNx], float dk[kNx]) {
  const float rm = 1.f / z[0];
  const float dmr = dz[0] * rm;
  const float v0 = z[4], v1 = z[5], v2 = z[6];
  const float dv0 = dz[4], dv1 = dz[5], dv2 = dz[6];
  const float qw = z[7], qx = z[8], qy = z[9], qz = z[10];
  const float dqw = dz[7], dqx = dz[8], dqy = dz[9], dqz = dz[10];
  const float w0 = z[11], w1 = z[12], w2 = z[13];
  const float dw0 = dz[11], dw1 = dz[12], dw2 = dz[13];

  // C_IB(q) and its derivative along dq, row-major
  const float C[9] = {1.f - 2.f * (qy * qy + qz * qz), 2.f * (qx * qy - qw * qz),
                      2.f * (qx * qz + qw * qy),       2.f * (qx * qy + qw * qz),
                      1.f - 2.f * (qx * qx + qz * qz), 2.f * (qy * qz - qw * qx),
                      2.f * (qx * qz - qw * qy),       2.f * (qy * qz + qw * qx),
                      1.f - 2.f * (qx * qx + qy * qy)};
  const float dC[9] = {-4.f * (qy * dqy + qz * dqz),
                       2.f * (dqx * qy + qx * dqy - dqw * qz - qw * dqz),
                       2.f * (dqx * qz + qx * dqz + dqw * qy + qw * dqy),
                       2.f * (dqx * qy + qx * dqy + dqw * qz + qw * dqz),
                       -4.f * (qx * dqx + qz * dqz),
                       2.f * (dqy * qz + qy * dqz - dqw * qx - qw * dqx),
                       2.f * (dqx * qz + qx * dqz - dqw * qy - qw * dqy),
                       2.f * (dqy * qz + qy * dqz + dqw * qx + qw * dqx),
                       -4.f * (qx * dqx + qy * dqy)};

  // the aero force in the body frame, F_A = −ka (C_A v_B) ‖v‖_ε, v_B = Cᵀ v
  float vB[3], dvB[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    vB[j] = C[j] * v0 + C[3 + j] * v1 + C[6 + j] * v2;
    dvB[j] = dC[j] * v0 + dC[3 + j] * v1 + dC[6 + j] * v2 + C[j] * dv0 + C[3 + j] * dv1 +
             C[6 + j] * dv2;
  }
  const float vmag = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + p.eps2);
  const float dvmag = (v0 * dv0 + v1 * dv1 + v2 * dv2) * (1.f / vmag);
  float a[3], da[3];
  mat3(p.CA, vB[0], vB[1], vB[2], a);
  mat3(p.CA, dvB[0], dvB[1], dvB[2], da);
  float FA[3], dFA[3], s[3], ds[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    FA[i] = -p.ka * a[i] * vmag;
    dFA[i] = -p.ka * (da[i] * vmag + a[i] * dvmag);
    s[i] = u[i] + FA[i];
    ds[i] = du[i] + dFA[i];
  }

  k[0] = -p.alpha * T;
  dk[0] = -p.alpha * ((u[0] * du[0] + u[1] * du[1] + u[2] * du[2]) * rT);
  k[1] = v0;
  k[2] = v1;
  k[3] = v2;
  dk[1] = dv0;
  dk[2] = dv1;
  dk[3] = dv2;
  // v̇ = C s/m + g; d(C s/m) = (dC s + C ds − C s·dm/m)/m
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float Cs = C[3 * i] * s[0] + C[3 * i + 1] * s[1] + C[3 * i + 2] * s[2];
    const float dCs = dC[3 * i] * s[0] + dC[3 * i + 1] * s[1] + dC[3 * i + 2] * s[2] +
                      C[3 * i] * ds[0] + C[3 * i + 1] * ds[1] + C[3 * i + 2] * ds[2];
    k[4 + i] = Cs * rm + p.g[i];
    dk[4 + i] = (dCs - Cs * dmr) * rm;
  }

  // q̇ = ½ [−ω·q_v ; q_w ω + ω × q_v]
  k[7] = -0.5f * (w0 * qx + w1 * qy + w2 * qz);
  k[8] = 0.5f * (qw * w0 + (w1 * qz - w2 * qy));
  k[9] = 0.5f * (qw * w1 + (w2 * qx - w0 * qz));
  k[10] = 0.5f * (qw * w2 + (w0 * qy - w1 * qx));
  dk[7] = -0.5f * (dw0 * qx + dw1 * qy + dw2 * qz + w0 * dqx + w1 * dqy + w2 * dqz);
  dk[8] = 0.5f * (dqw * w0 + qw * dw0 + dw1 * qz + w1 * dqz - dw2 * qy - w2 * dqy);
  dk[9] = 0.5f * (dqw * w1 + qw * dw1 + dw2 * qx + w2 * dqx - dw0 * qz - w0 * dqz);
  dk[10] = 0.5f * (dqw * w2 + qw * dw2 + dw0 * qy + w0 * dqy - dw1 * qx - w1 * dqx);

  // ω̇ = J⁻¹ (r_T × u + r_cp × F_A − ω × J ω)
  float h[3], dh[3];
  mat3(p.J, w0, w1, w2, h);
  mat3(p.J, dw0, dw1, dw2, dh);
  const float* rt = p.rT;
  const float* rc = p.rcp;
  const float tq[3] = {
      (rt[1] * u[2] - rt[2] * u[1]) + (rc[1] * FA[2] - rc[2] * FA[1]) - (w1 * h[2] - w2 * h[1]),
      (rt[2] * u[0] - rt[0] * u[2]) + (rc[2] * FA[0] - rc[0] * FA[2]) - (w2 * h[0] - w0 * h[2]),
      (rt[0] * u[1] - rt[1] * u[0]) + (rc[0] * FA[1] - rc[1] * FA[0]) - (w0 * h[1] - w1 * h[0])};
  const float dtq[3] = {
      (rt[1] * du[2] - rt[2] * du[1]) + (rc[1] * dFA[2] - rc[2] * dFA[1]) -
          (dw1 * h[2] - dw2 * h[1]) - (w1 * dh[2] - w2 * dh[1]),
      (rt[2] * du[0] - rt[0] * du[2]) + (rc[2] * dFA[0] - rc[0] * dFA[2]) -
          (dw2 * h[0] - dw0 * h[2]) - (w2 * dh[0] - w0 * dh[2]),
      (rt[0] * du[1] - rt[1] * du[0]) + (rc[0] * dFA[1] - rc[1] * dFA[0]) -
          (dw0 * h[1] - dw1 * h[0]) - (w0 * dh[1] - w1 * dh[0])};
  mat3(p.Ji, tq[0], tq[1], tq[2], k + 11);
  mat3(p.Ji, dtq[0], dtq[1], dtq[2], dk + 11);
}

// Knot k of the block's nb lanes out of the staged buffer sk, by thread t.
__device__ __forceinline__ void store_knot(const float* sk, int t, int b0, int nb, int N, int k,
                                           float* X, float* A, float* Bm, float* c) {
  for (int e = t; e < nb * kNx * kNx; e += kThreads) {
    const int l = e / (kNx * kNx);
    const int r = e - l * (kNx * kNx);
    A[((size_t)(b0 + l) * N + k) * (kNx * kNx) + r] = sk[l * kStride + kOffA + r];
  }
  for (int e = t; e < nb * kNx * kNu; e += kThreads) {
    const int l = e / (kNx * kNu);
    const int r = e - l * (kNx * kNu);
    Bm[((size_t)(b0 + l) * N + k) * (kNx * kNu) + r] = sk[l * kStride + kOffB + r];
  }
  for (int e = t; e < nb * kNx; e += kThreads) {
    const int l = e / kNx;
    const int i = e - l * kNx;
    const float* s = sk + l * kStride;
    float ci = fmaf(-s[kOffA + i * kNx + i], s[kOffX + i], s[kOffF + i]);
#pragma unroll
    for (int j = 0; j < kNx; ++j) {
      if (j != i) ci = fmaf(-s[kOffA + i * kNx + j], s[kOffX + j], ci);
    }
#pragma unroll
    for (int j = 0; j < kNu; ++j) ci = fmaf(-s[kOffB + i * kNu + j], s[kOffU + j], ci);
    c[((size_t)(b0 + l) * N + k) * kNx + i] = ci;
    X[((size_t)(b0 + l) * (N + 1) + k + 1) * kNx + i] = s[kOffN + i];
  }
}

__global__ void __launch_bounds__(kThreads)
rollout_linearize6dof_kernel(const float* __restrict__ x0, const float* __restrict__ U,
                             const float* __restrict__ tape, float* __restrict__ X,
                             float* __restrict__ A, float* __restrict__ Bm,
                             float* __restrict__ c, int B, int N,
                             const __grid_constant__ Model p) {
  __shared__ float stage[2 * kBuffer];  // [2][kLanes][kStride]
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int col = tid / kLanes;
  // the column's state index (m, then v, q, ω), or −1 for a control column
  const int xcol = col == 0 ? 0 : (col < 11 ? col + 3 : -1);
  const int ucol = col - 11;
  const int b0 = blockIdx.x * kLanes;
  const int nb = min(kLanes, B - b0);  // this block's lanes
  // a thread past the last lane runs that lane's chain and stores nothing
  const int b = b0 + min(lane, nb - 1);

  // the position columns of A, the same in every knot: e_j, j = 1, 2, 3
  for (int e = tid; e < 2 * kLanes * kNx * 3; e += kThreads) {
    const int l = e / (kNx * 3);  // a buffer's lane, over both buffers
    const int r = e - l * (kNx * 3);
    const int i = r / 3;
    const int j = 1 + (r - 3 * i);
    stage[l * kStride + kOffA + i * kNx + j] = i == j ? 1.f : 0.f;
  }
  for (int e = tid; e < nb * kNx; e += kThreads) {
    const int l = e / kNx;
    X[(size_t)(b0 + l) * (N + 1) * kNx + (e - l * kNx)] = x0[(size_t)b0 * kNx + e];
  }

  float x[kNx];
#pragma unroll
  for (int i = 0; i < kNx; ++i) x[i] = x0[(size_t)b * kNx + i];
  const float du[kNu] = {ucol == 0 ? 1.f : 0.f, ucol == 1 ? 1.f : 0.f, ucol == 2 ? 1.f : 0.f};
  const float* Ub = U + (size_t)b * N * kNu;
  const float* Tb = tape ? tape + (size_t)b * N * kNx : nullptr;
  float un[kNu], tn[kNx];
#pragma unroll
  for (int j = 0; j < kNu; ++j) un[j] = Ub[j];
#pragma unroll
  for (int i = 0; i < kNx; ++i) tn[i] = Tb ? Tb[i] : 0.f;

  for (int k = 0; k <= N; ++k) {
    if (k > 0) store_knot(stage + ((k - 1) & 1) * kBuffer, tid, b0, nb, N, k - 1, X, A, Bm, c);
    if (k < N) {
      float u[kNu], tk[kNx];
#pragma unroll
      for (int j = 0; j < kNu; ++j) u[j] = un[j];
#pragma unroll
      for (int i = 0; i < kNx; ++i) tk[i] = tn[i];
      if (k + 1 < N) {  // the next knot's inputs, a knot ahead
#pragma unroll
        for (int j = 0; j < kNu; ++j) un[j] = Ub[(k + 1) * kNu + j];
        if (Tb) {
#pragma unroll
          for (int i = 0; i < kNx; ++i) tn[i] = Tb[(k + 1) * kNx + i];
        }
      }
      const float T = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + p.eps2);
      const float rT = 1.f / T;

      // RK4, primal and this thread's tangent column together; the
      // tangent of x_k is e_xcol (zero for a control column)
      float z[kNx], dz[kNx], kk[kNx], dk[kNx], acc[kNx], dacc[kNx];
#pragma unroll
      for (int i = 0; i < kNx; ++i) dz[i] = i == xcol ? 1.f : 0.f;
      f_jvp(p, x, dz, u, du, T, rT, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] = kk[i];
        dacc[i] = dk[i];
        z[i] = x[i] + p.h2 * kk[i];
        dz[i] = (i == xcol ? 1.f : 0.f) + p.h2 * dk[i];
      }
      f_jvp(p, z, dz, u, du, T, rT, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] += 2.f * kk[i];
        dacc[i] += 2.f * dk[i];
        z[i] = x[i] + p.h2 * kk[i];
        dz[i] = (i == xcol ? 1.f : 0.f) + p.h2 * dk[i];
      }
      f_jvp(p, z, dz, u, du, T, rT, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] += 2.f * kk[i];
        dacc[i] += 2.f * dk[i];
        z[i] = x[i] + p.h * kk[i];
        dz[i] = (i == xcol ? 1.f : 0.f) + p.h * dk[i];
      }
      f_jvp(p, z, dz, u, du, T, rT, kk, dk);
      float F[kNx], dF[kNx];
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        F[i] = x[i] + p.h6 * (acc[i] + kk[i]);
        dF[i] = (i == xcol ? 1.f : 0.f) + p.h6 * (dacc[i] + dk[i]);
      }
      // the renormalised quaternion, q̂ = q̃/‖q̃‖, dq̂ = (dq̃ − q̂ (q̂·dq̃))/‖q̃‖
      const float rn = 1.f / sqrtf(F[7] * F[7] + F[8] * F[8] + F[9] * F[9] + F[10] * F[10]);
      const float q0 = F[7] * rn, q1 = F[8] * rn, q2 = F[9] * rn, q3 = F[10] * rn;
      const float proj = q0 * dF[7] + q1 * dF[8] + q2 * dF[9] + q3 * dF[10];
      dF[7] = (dF[7] - q0 * proj) * rn;
      dF[8] = (dF[8] - q1 * proj) * rn;
      dF[9] = (dF[9] - q2 * proj) * rn;
      dF[10] = (dF[10] - q3 * proj) * rn;
      F[7] = q0;
      F[8] = q1;
      F[9] = q2;
      F[10] = q3;

      float* st = stage + (k & 1) * kBuffer + lane * kStride;
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        if (xcol >= 0) {
          st[kOffA + i * kNx + xcol] = dF[i];
        } else {
          st[kOffB + i * kNu + ucol] = dF[i];
        }
        const float xn = Tb ? F[i] + p.rdt * tk[i] : F[i];
        if (col == 0) {
          st[kOffF + i] = F[i];
          st[kOffX + i] = x[i];
          st[kOffN + i] = xn;
        }
        x[i] = xn;
      }
      if (col == 0) {
#pragma unroll
        for (int j = 0; j < kNu; ++j) st[kOffU + j] = u[j];
      }
    }
    // knot k staged and knot k−1 stored: the next iteration stores the one
    // just staged and computes into the buffer just stored
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x0 (B,14), U (B,N,3), tape (B,N,14) or null; outputs X (B,N+1,14),
// A (B,N,14,14), Bm (B,N,14,3), c (B,N,14); model: the kModelFloats floats
// of Model, in its order, in host memory. Returns the CUDA error of the
// launch.
int rollout_linearize6dof_f32(const float* x0, const float* U, const float* tape, float* X,
                              float* A, float* Bm, float* c, int B, int N, const float* model,
                              void* stream) {
  if (B <= 0 || N <= 0 || model == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Model p;
  std::memcpy(&p, model, sizeof(Model));
  const int blocks = (B + kLanes - 1) / kLanes;
  rollout_linearize6dof_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, U, tape, X, A, Bm, c, B, N, p);
  return static_cast<int>(cudaGetLastError());
}

// threads and lanes a block of the launch, and the floats of its model, for
// reports and the wrapper's checks
int rollout_linearize6dof_threads() { return kThreads; }
int rollout_linearize6dof_lanes() { return kLanes; }
int rollout_linearize6dof_model_floats() { return kModelFloats; }

}  // extern "C"
