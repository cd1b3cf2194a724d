// Re-anchoring RK4 rollout of the 3-DoF point-mass rocket and the exact
// Jacobians of each of its steps, for a batch of lanes, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses the rollout's scan and vmap(jacfwd(F)) over the knots. Eager PyTorch
// runs it as a Python loop of RK4 steps and then torch.func's jacfwd: 1,945
// launches a cycle on the GP-MPC main path (20 knots, 512 lanes). This
// kernel does the same work in one launch.
//
// For every lane b, from x_0 = x0[b], and every knot k = 0 … N−1:
//
//     F_k             = RK4 step of f (rocket3dof.py::f) from x_k under u_k = U[b,k]
//     [A_k | B_k]     = ∂F/∂[x, u] at (x_k, u_k)
//     c_k             = F_k − A_k x_k − B_k u_k
//     x_{k+1}         = F_k + rdt·tape[b,k]       (F_k where no tape is given)
//
// Outputs X (B,N+1,7) = [x_0 … x_N], A (B,N,7,7), B (B,N,7,3), c (B,N,7),
// all row-major. float32 throughout, with f's formula and its ε guards:
//
//     ṁ = −α‖u‖_ε,  ṙ = v,  v̇ = u/m + g + a_d,  a_d = −k_d‖v‖_ε v/m,
//     ‖w‖_ε = sqrt(w·w + ε²).
//
// The tangent is carried through the four RK4 stages in forward mode, with
// ∂f written out: ∂ṁ/∂u = −α u/‖u‖_ε; ∂ṙ/∂v = I; ∂v̇/∂m = −u/m² − a_d/m;
// ∂v̇/∂v = −(k_d/m)(‖v‖_ε I + v vᵀ/‖v‖_ε); ∂v̇/∂u = I/m.
//
// Thread mapping. A block takes 32 lanes and has ten warps, one lane a
// thread of each. Warp j (j = 0 or 4 ≤ j ≤ 9) carries tangent column j
// (∂/∂x_j for j < 7, ∂/∂u_{j−7} after) for its 32 lanes and computes the
// lane's primal chain itself, so that no thread waits on another inside a
// knot: a lane is a chain of N knots of four dependent stages, and the
// threads cut it to one column's work a stage (~40 operations) where one
// thread a lane would carry all ten. The position columns are e_j exactly
// (f does not read r, and jacfwd carries its zeros exactly), so warps 1-3
// compute nothing: they are the block's store warps.
//
// Stores. Each knot's A_k, B_k, F_k, x_k, u_k and x_{k+1} of the block's
// lanes are staged in shared memory, double-buffered: while the compute
// warps run knot k, the store warps write knot k−1 out, consecutive threads
// on consecutive addresses of one lane's contiguous A_{k−1} (49 floats),
// B_{k−1} (21), c_{k−1} (7) and x_k (7), and form c_{k−1} from the staged
// row (F_i minus the products by one fused multiply-add each, the diagonal
// A_ii x_i first: F_i ≈ x_i, and that cancellation is then exact). One
// barrier a knot. A compute thread would otherwise store across lanes at
// the stride of a lane's whole output (3,920 bytes for A at N = 20).
//
// Arithmetic. Each stage divides once by m and by ‖v‖_ε, each knot once by
// ‖u‖_ε, and multiplies by the reciprocals.
//
// Bound on an NVIDIA H100 (3.35 TB/s, 67 TFLOP/s f32): bytes. A lane reads
// 828 bytes (x0, U, the tape) and writes 6,748 (N = 20), ~1.2 µs at 512
// lanes and ~9.3 µs at 4,096; its ~59 kFLOP (ops/kernels/rollout_linearize.py
// ::_KERNELS) take ~3.6 µs at 4,096. The next knot's u and tape are
// loaded a knot ahead. Measured (H100 80GB HBM3, 700 W, CUDA-graph
// replays): 0.037 ms a launch at 512 and at 4,096 lanes alike, so a
// block's chain of knots sets the time, not the card's width: the store
// warps alone take 0.034 ms. Divisions at every use (zero numerators of
// the tangent included) took 0.133 ms; every warp storing after each
// knot's barrier, with no overlap, 0.040 ms. The launch runs on the
// caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kNx = 7;
constexpr int kNu = 3;
constexpr int kLanes = 32;                 // lanes a block, one a thread of each warp
constexpr int kThreads = kLanes * (kNx + kNu);  // warp j carries tangent column j
// a lane's staged knot: A_k, B_k, F_k, x_k, u_k, x_{k+1}
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kNx * kNx;
constexpr int kOffF = kOffB + kNx * kNu;
constexpr int kOffX = kOffF + kNx;
constexpr int kOffU = kOffX + kNx;
constexpr int kOffN = kOffU + kNu;
constexpr int kStride = kOffN + kNx + 1;   // 95, odd: a warp's 32 lanes on 32 banks
static_assert(kStride % 2 == 1, "the staging stride must be odd");

struct Model {
  float alpha;   // 1/(I_sp g0)
  float g0, g1, g2;  // gravity in the inertial frame
  float kd;      // ½ ρ C_D A_ref
  float eps2;    // ε² of the ‖u‖ and ‖v‖ guards
  float h2;      // dt/2 of the RK4 step
  float h;       // dt
  float h6;      // dt/6
  float rdt;     // the time step the residual tape is scaled by
};
constexpr int kModelFloats = 10;
static_assert(sizeof(Model) == kModelFloats * sizeof(float), "Model is a packed float array");

// f(z, u) into k, and its derivative along (dz, du) into dk; du is a unit
// vector (du0, du1, du2) or zero. rT = 1/‖u‖_ε, the same at every stage.
__device__ __forceinline__ void f_jvp(const Model& p, const float z[kNx], const float dz[kNx],
                                      float u0, float u1, float u2, float T, float rT,
                                      float du0, float du1, float du2,
                                      float k[kNx], float dk[kNx]) {
  const float rm = 1.f / z[0];
  const float v0 = z[4], v1 = z[5], v2 = z[6];
  const float vmag = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + p.eps2);
  const float rv = 1.f / vmag;
  const float s = -p.kd * vmag;  // a_d = s·v/m
  k[0] = -p.alpha * T;
  k[1] = v0;
  k[2] = v1;
  k[3] = v2;
  k[4] = u0 * rm + p.g0 + s * v0 * rm;
  k[5] = u1 * rm + p.g1 + s * v1 * rm;
  k[6] = u2 * rm + p.g2 + s * v2 * rm;

  const float dv0 = dz[4], dv1 = dz[5], dv2 = dz[6];
  const float ds = -p.kd * ((v0 * dv0 + v1 * dv1 + v2 * dv2) * rv);
  const float dmr = dz[0] * rm;
  dk[0] = -p.alpha * ((u0 * du0 + u1 * du1 + u2 * du2) * rT);
  dk[1] = dv0;
  dk[2] = dv1;
  dk[3] = dv2;
  // d(u/m + s v/m) = (du + ds·v + s·dv − (u + s·v)·dm/m)/m
  dk[4] = (du0 + ds * v0 + s * dv0 - (u0 + s * v0) * dmr) * rm;
  dk[5] = (du1 + ds * v1 + s * dv1 - (u1 + s * v1) * dmr) * rm;
  dk[6] = (du2 + ds * v2 + s * dv2 - (u2 + s * v2) * dmr) * rm;
}

// Knot k−1 of the block's nb lanes out of the staged buffer sk, by the 96
// threads t of the store warps.
__device__ __forceinline__ void store_knot(const float* sk, int t, int b0, int nb, int N, int k,
                                           float* X, float* A, float* Bm, float* c) {
  constexpr int kStoreThreads = 3 * kLanes;
  for (int e = t; e < nb * kNx * kNx; e += kStoreThreads) {
    const int l = e / (kNx * kNx);
    const int r = e - l * (kNx * kNx);
    A[((size_t)(b0 + l) * N + k) * (kNx * kNx) + r] = sk[l * kStride + kOffA + r];
  }
  for (int e = t; e < nb * kNx * kNu; e += kStoreThreads) {
    const int l = e / (kNx * kNu);
    const int r = e - l * (kNx * kNu);
    Bm[((size_t)(b0 + l) * N + k) * (kNx * kNu) + r] = sk[l * kStride + kOffB + r];
  }
  for (int e = t; e < nb * kNx; e += kStoreThreads) {
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
rollout_linearize_kernel(const float* __restrict__ x0, const float* __restrict__ U,
                         const float* __restrict__ tape, float* __restrict__ X,
                         float* __restrict__ A, float* __restrict__ Bm,
                         float* __restrict__ c, int B, int N, Model p) {
  __shared__ float stage[2][kLanes * kStride];
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int col = tid / kLanes;  // warp-uniform
  const bool stores = col >= 1 && col <= 3;  // the position columns' warps
  const int b0 = blockIdx.x * kLanes;
  const int nb = min(kLanes, B - b0);  // this block's lanes
  // a thread past the last lane runs that lane's chain and stores nothing
  const int b = b0 + min(lane, nb - 1);
  const bool tangent_x = col < kNx;
  const float du0 = col == kNx ? 1.f : 0.f;
  const float du1 = col == kNx + 1 ? 1.f : 0.f;
  const float du2 = col == kNx + 2 ? 1.f : 0.f;

  if (stores) {
    // the position columns of A, the same in every knot: e_col
    for (int e = lane; e < kLanes * kNx; e += kLanes) {
      const int l = e / kNx;
      const int i = e - l * kNx;
      stage[0][l * kStride + kOffA + i * kNx + col] = i == col ? 1.f : 0.f;
      stage[1][l * kStride + kOffA + i * kNx + col] = i == col ? 1.f : 0.f;
    }
    for (int e = tid - kLanes; e < nb * kNx; e += 3 * kLanes) {
      const int l = e / kNx;
      X[(size_t)(b0 + l) * (N + 1) * kNx + (e - l * kNx)] = x0[(size_t)b0 * kNx + e];
    }
  }
  __syncthreads();

  float x[kNx];
#pragma unroll
  for (int i = 0; i < kNx; ++i) x[i] = x0[b * kNx + i];
  const float* Ub = U + (size_t)b * N * kNu;
  const float* Tb = tape ? tape + (size_t)b * N * kNx : nullptr;
  float un0 = Ub[0], un1 = Ub[1], un2 = Ub[2];
  float tn[kNx];
#pragma unroll
  for (int i = 0; i < kNx; ++i) tn[i] = Tb ? Tb[i] : 0.f;

  for (int k = 0; k <= N; ++k) {
    if (stores) {
      if (k > 0) store_knot(stage[(k - 1) & 1], tid - kLanes, b0, nb, N, k - 1, X, A, Bm, c);
    } else if (k < N) {
      const float u0 = un0, u1 = un1, u2 = un2;
      float tk[kNx];
#pragma unroll
      for (int i = 0; i < kNx; ++i) tk[i] = tn[i];
      if (k + 1 < N) {  // the next knot's inputs, a knot ahead
        un0 = Ub[(k + 1) * kNu];
        un1 = Ub[(k + 1) * kNu + 1];
        un2 = Ub[(k + 1) * kNu + 2];
        if (Tb) {
#pragma unroll
          for (int i = 0; i < kNx; ++i) tn[i] = Tb[(k + 1) * kNx + i];
        }
      }
      const float T = sqrtf(u0 * u0 + u1 * u1 + u2 * u2 + p.eps2);
      const float rT = 1.f / T;

      // RK4, primal and this warp's tangent column together
      float dx[kNx], z[kNx], dz[kNx], kk[kNx], dk[kNx], acc[kNx], dacc[kNx];
#pragma unroll
      for (int i = 0; i < kNx; ++i) dx[i] = (tangent_x && i == col) ? 1.f : 0.f;
      f_jvp(p, x, dx, u0, u1, u2, T, rT, du0, du1, du2, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] = kk[i];
        dacc[i] = dk[i];
        z[i] = x[i] + p.h2 * kk[i];
        dz[i] = dx[i] + p.h2 * dk[i];
      }
      f_jvp(p, z, dz, u0, u1, u2, T, rT, du0, du1, du2, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] += 2.f * kk[i];
        dacc[i] += 2.f * dk[i];
        z[i] = x[i] + p.h2 * kk[i];
        dz[i] = dx[i] + p.h2 * dk[i];
      }
      f_jvp(p, z, dz, u0, u1, u2, T, rT, du0, du1, du2, kk, dk);
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        acc[i] += 2.f * kk[i];
        dacc[i] += 2.f * dk[i];
        z[i] = x[i] + p.h * kk[i];
        dz[i] = dx[i] + p.h * dk[i];
      }
      f_jvp(p, z, dz, u0, u1, u2, T, rT, du0, du1, du2, kk, dk);

      float* st = stage[k & 1] + lane * kStride;
#pragma unroll
      for (int i = 0; i < kNx; ++i) {
        const float F = x[i] + p.h6 * (acc[i] + kk[i]);
        const float dF = dx[i] + p.h6 * (dacc[i] + dk[i]);
        if (tangent_x) {
          st[kOffA + i * kNx + col] = dF;
        } else {
          st[kOffB + i * kNu + (col - kNx)] = dF;
        }
        const float xn = Tb ? F + p.rdt * tk[i] : F;
        if (col == 0) {
          st[kOffF + i] = F;
          st[kOffX + i] = x[i];
          st[kOffN + i] = xn;
        }
        x[i] = xn;
      }
      if (col == 0) {
        st[kOffU] = u0;
        st[kOffU + 1] = u1;
        st[kOffU + 2] = u2;
      }
    }
    // knot k staged and knot k−1 stored: the next iteration computes into
    // the buffer just stored and stores the one just staged
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x0 (B,7), U (B,N,3), tape (B,N,7) or null; outputs X (B,N+1,7), A (B,N,7,7),
// Bm (B,N,7,3), c (B,N,7); model: the kModelFloats floats of Model, in its
// order, in host memory. Returns the CUDA error of the launch.
int rollout_linearize_f32(const float* x0, const float* U, const float* tape, float* X,
                          float* A, float* Bm, float* c, int B, int N, const float* model,
                          void* stream) {
  if (B <= 0 || N <= 0 || model == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Model p;
  std::memcpy(&p, model, sizeof(Model));
  const int blocks = (B + kLanes - 1) / kLanes;
  rollout_linearize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, U, tape, X, A, Bm, c, B, N, p);
  return static_cast<int>(cudaGetLastError());
}

// threads and lanes a block of the launch, and the floats of its model, for
// reports and the wrapper's checks
int rollout_linearize_threads() { return kThreads; }
int rollout_linearize_lanes() { return kLanes; }
int rollout_linearize_model_floats() { return kModelFloats; }

}  // extern "C"
