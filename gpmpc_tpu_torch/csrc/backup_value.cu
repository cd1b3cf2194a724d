// The safety filter's backup rollout and its gradient: the terminal value
// V(x_N(u)) of every lane and ∂V/∂u, in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates the rollout with
// jax.grad under vmap and leaves it to XLA. Eager PyTorch runs it as an
// autograd tape: ~1,500 launches an evaluation, two evaluations a filtered
// step (safety/safety_filter.py::_value_and_grad). This kernel computes the
// same values and subgradients in one launch an evaluation.
//
// For every lane b, from x_0 = x[b] and the candidate control u = u[b]:
//
//     x_1     = F(x_0, u)
//     x_{k+1} = F(x_k, u_b(x_k))                  k = 1 … N−1
//     V       = ‖v_N‖² − slope·max(h_N, 0)        (v = x[4:7], h = x[1])
//     g       = ∂V/∂u                             (3 columns)
//
// F is the 3-DoF RK4 step of rocket3dof.py::f (the formula and ε guards of
// rollout_linearize.cu), plus dt·gust·σ(6 − h) on x[4] where the step is
// Rocket3DoFDowndraftStep (gust = 0 for a plain Rocket3DoFStep); u_b is
// safety/backup_controller.py::EmergencyBrakingController.control; V is
// safety/invariant_sets.py::DescentFunnelSet.value. float32 throughout.
//
// The tangent ∂x_k/∂u (7 × 3) is carried forward with the primal, so g
// comes out of the same pass. At every kink it takes the subgradient that
// PyTorch's autograd takes on the eager route:
//
//     clamp_min(h, 0)              passes the derivative at h = 0 (h ≥ 0);
//     clamp(T/‖u‖, max = 1)        passes it at equality (T/‖u‖ ≤ 1);
//     sqrt(clamp_min(u·u, 1e-12))  has derivative 0 where u·u < 1e-12;
//     ‖v‖² ≤ 1e-12                 takes the constant direction "up", with
//                                  derivative 0 in v;
//     dt·gust·σ(6 − h)             has derivative −dt·gust·σ(1 − σ) in h.
//
// Thread mapping. A block takes 32 lanes and has three warps; warp j carries
// tangent column j (∂/∂u_j) for its 32 lanes, one lane a thread, and computes
// the lane's primal chain itself, so that no thread waits on another: a lane
// is a chain of N steps of four dependent RK4 stages and N − 1 backup
// controls, and the split cuts each thread's work to one column's (~40
// operations a stage) where one thread a lane would carry all three.
// Warp 0 writes V too. No shared memory, no barrier.
//
// Bound on an NVIDIA H100 (3.35 TB/s, 67 TFLOP/s f32): a lane reads 40
// bytes (x, u) and writes 16 (V, g): ~57 KB at 1,024 lanes, ~0.02 µs; its
// ~5.4 kFLOP (ops/kernels/backup_value.py::flops_per_lane at N = 5) make
// ~5.6 MFLOP, ~0.08 µs. Both lie far under a launch's own latency: the
// kernel is latency-bound (its chain of 20 dependent RK4 stages), and its
// point is one launch in place of ~1,500, not bandwidth. The launch runs on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kNx = 7;
constexpr int kNu = 3;
constexpr int kLanes = 32;                 // lanes a block, one a thread of each warp
constexpr int kThreads = kLanes * kNu;     // warp j carries tangent column j

struct Model {
  float alpha;       // 1/(I_sp g0)
  float g0, g1, g2;  // gravity in the inertial frame
  float kd;          // ½ ρ C_D A_ref
  float eps2;        // ε² of the ‖u‖ and ‖v‖ guards
  float h2;          // dt/2 of the RK4 step
  float h;           // dt
  float h6;          // dt/6
  float gust;        // the downdraft's scale (0: none)
  float T;           // the backup's T_max
  float b0, b1, b2;  // the backup's g_I
  float slope;       // the funnel's slope
};
constexpr int kModelFloats = 15;
static_assert(sizeof(Model) == kModelFloats * sizeof(float), "Model is a packed float array");

// f(z, u) into k, and its derivative along (dz, du) into dk. T = ‖u‖_ε and
// dT = u·du/T, the same at every stage of a step.
__device__ __forceinline__ void f_jvp(const Model& p, const float z[kNx], const float dz[kNx],
                                      const float u[kNu], const float du[kNu], float T,
                                      float dT, float k[kNx], float dk[kNx]) {
  const float rm = 1.f / z[0];
  const float v0 = z[4], v1 = z[5], v2 = z[6];
  const float vmag = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + p.eps2);
  const float s = -p.kd * vmag;  // a_d = s·v/m
  k[0] = -p.alpha * T;
  k[1] = v0;
  k[2] = v1;
  k[3] = v2;
  k[4] = u[0] * rm + p.g0 + s * v0 * rm;
  k[5] = u[1] * rm + p.g1 + s * v1 * rm;
  k[6] = u[2] * rm + p.g2 + s * v2 * rm;

  const float dv0 = dz[4], dv1 = dz[5], dv2 = dz[6];
  const float ds = -p.kd * ((v0 * dv0 + v1 * dv1 + v2 * dv2) / vmag);
  const float dmr = dz[0] * rm;
  dk[0] = -p.alpha * dT;
  dk[1] = dv0;
  dk[2] = dv1;
  dk[3] = dv2;
  // d(u/m + s v/m) = (du + ds·v + s·dv − (u + s·v)·dm/m)/m
  dk[4] = (du[0] + ds * v0 + s * dv0 - (u[0] + s * v0) * dmr) * rm;
  dk[5] = (du[1] + ds * v1 + s * dv1 - (u[1] + s * v1) * dmr) * rm;
  dk[6] = (du[2] + ds * v2 + s * dv2 - (u[2] + s * v2) * dmr) * rm;
}

// x ← F(x, u) and dx ← its derivative along (dx, du): the RK4 step, then
// the downdraft at the step's starting altitude.
__device__ __forceinline__ void step_jvp(const Model& p, float x[kNx], float dx[kNx],
                                         const float u[kNu], const float du[kNu]) {
  const float T = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + p.eps2);
  const float dT = (u[0] * du[0] + u[1] * du[1] + u[2] * du[2]) / T;
  float z[kNx], dz[kNx], kk[kNx], dk[kNx], acc[kNx], dacc[kNx];
  f_jvp(p, x, dx, u, du, T, dT, kk, dk);
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    acc[i] = kk[i];
    dacc[i] = dk[i];
    z[i] = x[i] + p.h2 * kk[i];
    dz[i] = dx[i] + p.h2 * dk[i];
  }
  f_jvp(p, z, dz, u, du, T, dT, kk, dk);
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    acc[i] += 2.f * kk[i];
    dacc[i] += 2.f * dk[i];
    z[i] = x[i] + p.h2 * kk[i];
    dz[i] = dx[i] + p.h2 * dk[i];
  }
  f_jvp(p, z, dz, u, du, T, dT, kk, dk);
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    acc[i] += 2.f * kk[i];
    dacc[i] += 2.f * dk[i];
    z[i] = x[i] + p.h * kk[i];
    dz[i] = dx[i] + p.h * dk[i];
  }
  f_jvp(p, z, dz, u, du, T, dT, kk, dk);
  // the downdraft reads the altitude the step starts from
  const float sig = 1.f / (1.f + expf(x[1] - 6.f));  // σ(6 − h)
  const float gust = p.h * (p.gust * sig);
  const float dgust = -p.h * (p.gust * (sig * (1.f - sig))) * dx[1];
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    x[i] = x[i] + p.h6 * (acc[i] + kk[i]);
    dx[i] = dx[i] + p.h6 * (dacc[i] + dk[i]);
  }
  x[4] += gust;
  dx[4] += dgust;
}

// u ← u_b(x) and du ← its derivative along dx: thrust T against the
// velocity, less m·g_I, scaled into ‖u‖ ≤ T.
__device__ __forceinline__ void braking_jvp(const Model& p, const float x[kNx],
                                            const float dx[kNx], float u[kNu], float du[kNu]) {
  const float v0 = x[4], v1 = x[5], v2 = x[6];
  const float vsq = v0 * v0 + v1 * v1 + v2 * v2;
  float d0 = 1.f, d1 = 0.f, d2 = 0.f, dd0 = 0.f, dd1 = 0.f, dd2 = 0.f;
  if (vsq > 1e-12f) {  // moving: −v/‖v‖
    const float vmag = sqrtf(vsq);
    d0 = -v0 / vmag;
    d1 = -v1 / vmag;
    d2 = -v2 / vmag;
    const float dvmag = (v0 * dx[4] + v1 * dx[5] + v2 * dx[6]) / vmag;
    dd0 = (-dx[4] - d0 * dvmag) / vmag;
    dd1 = (-dx[5] - d1 * dvmag) / vmag;
    dd2 = (-dx[6] - d2 * dvmag) / vmag;
  }
  const float m = x[0], dm = dx[0];
  const float w0 = d0 * p.T - m * p.b0, w1 = d1 * p.T - m * p.b1, w2 = d2 * p.T - m * p.b2;
  const float dw0 = dd0 * p.T - dm * p.b0, dw1 = dd1 * p.T - dm * p.b1,
              dw2 = dd2 * p.T - dm * p.b2;
  const float wsq = w0 * w0 + w1 * w1 + w2 * w2;
  const bool above = wsq >= 1e-12f;  // clamp_min(w·w, 1e-12) passes the derivative
  const float wmag = sqrtf(above ? wsq : 1e-12f);
  const float dwmag = above ? (w0 * dw0 + w1 * dw1 + w2 * dw2) / wmag : 0.f;
  const float s = p.T * (1.f / wmag);
  const bool inside = s <= 1.f;  // clamp(s, max=1) passes the derivative at s = 1
  const float sc = inside ? s : 1.f;
  const float dsc = inside ? -s * dwmag / wmag : 0.f;
  u[0] = w0 * sc;
  u[1] = w1 * sc;
  u[2] = w2 * sc;
  du[0] = dw0 * sc + w0 * dsc;
  du[1] = dw1 * sc + w1 * dsc;
  du[2] = dw2 * sc + w2 * dsc;
}

__global__ void __launch_bounds__(kThreads)
backup_value_kernel(const float* __restrict__ xs, const float* __restrict__ us,
                    float* __restrict__ V, float* __restrict__ g, int B, int N, Model p) {
  const int col = threadIdx.x / kLanes;  // warp-uniform
  const int b = blockIdx.x * kLanes + (threadIdx.x & (kLanes - 1));
  if (b >= B) return;
  float x[kNx], dx[kNx], u[kNu], du[kNu];
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    x[i] = xs[b * kNx + i];
    dx[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kNu; ++j) {
    u[j] = us[b * kNu + j];
    du[j] = j == col ? 1.f : 0.f;
  }
  step_jvp(p, x, dx, u, du);
  for (int k = 1; k < N; ++k) {
    braking_jvp(p, x, dx, u, du);
    step_jvp(p, x, dx, u, du);
  }
  const bool above = x[1] >= 0.f;  // clamp_min(h, 0) passes the derivative at h = 0
  const float dV = 2.f * (x[4] * dx[4] + x[5] * dx[5] + x[6] * dx[6]) -
                   (above ? p.slope * dx[1] : 0.f);
  g[b * kNu + col] = dV;
  if (col == 0) {
    V[b] = (x[4] * x[4] + x[5] * x[5] + x[6] * x[6]) - p.slope * (above ? x[1] : 0.f);
  }
}

}  // namespace

extern "C" {

// x (B,7), u (B,3); outputs V (B,), g (B,3); N ≥ 1 steps (the candidate u,
// then N − 1 backup controls); model: the kModelFloats floats of Model, in
// its order, in host memory. Returns the CUDA error of the launch.
int backup_value_f32(const float* x, const float* u, float* V, float* g, int B, int N,
                     const float* model, void* stream) {
  if (B <= 0 || N <= 0 || model == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Model p;
  std::memcpy(&p, model, sizeof(Model));
  const int blocks = (B + kLanes - 1) / kLanes;
  backup_value_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, V, g, B, N, p);
  return static_cast<int>(cudaGetLastError());
}

// threads and lanes a block of the launch, and the floats of its model, for
// reports and the wrapper's checks
int backup_value_threads() { return kThreads; }
int backup_value_lanes() { return kLanes; }
int backup_value_model_floats() { return kModelFloats; }

}  // extern "C"
