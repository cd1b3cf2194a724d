// ADMM iteration chunk for a batch of QP lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernels in gpmpc_tpu/ops/pallas/admm_kernel.py:
// `admm_chunk` (body `_chunk_kernel`, one lane per grid cell) and
// `make_admm_chunk_lanes` (body `_lanes_kernel`, L lanes per grid cell).
// Both compute the same function, so one kernel serves both: for every lane
// b, starting from (x, z, y), run `iters` iterations of
//
//     t   = ρ∘z − y
//     x̃   = M⁻¹ (σx − q + Aᵀt)
//     z̃   = A x̃
//     x   ← αx̃ + (1−α)x
//     z_r = αz̃ + (1−α)z
//     z   ← clip(z_r + y/ρ, l, u)
//     y   ← y + ρ∘(z_r − z)
//
// and return (x, z, y). f32 throughout, FMA accumulation.
//
// What bounds it on this card. Per lane and iteration the work is three
// matvecs against loop-invariant matrices (2·(n² + 2mn) flops) and O(n+m)
// elementwise work; between the three stages every thread needs the whole
// previous vector, so an iteration is a chain of three dependent reductions.
// Streamed from device memory every iteration (what the XLA path does on the
// TPU) the matrices would cost iters × (n² + mn) × 4 bytes per lane; kept on
// chip they cost one read per chunk. At the main-path shape (n = m = 60,
// 50 iterations, 512 lanes) one chunk reads ≈15 MB (≈4.5 µs at 3.35 TB/s)
// and does ≈0.55 GFLOP as dense f32 FMA (≈8 µs at 67 TFLOP/s), but the
// chain of 150 dependent stages with a block barrier after each is what
// the run time is made of: latency, not bandwidth or arithmetic.
//
// What the design does about it:
// - One CTA per lane, one launch per chunk: all `iters` iterations run
//   inside the kernel, so the host launches once instead of a few hundred
//   tiny kernels per chunk.
// - M⁻¹ and A are copied into dynamic shared memory once per chunk (28.8 KB
//   a lane at n = m = 60) and the iterate lives in shared memory, so each
//   matrix crosses device memory once per chunk.
// - Thread j owns output element j of each matvec. Aᵀt and M⁻¹·rhs read
//   columns (neighbouring threads, neighbouring words: no bank conflicts;
//   M⁻¹ is symmetric, so its column is its row). A·x̃ reads rows, so A is
//   stored with an odd row stride (n | 1) to keep those reads conflict-free.
// - Four partial sums per dot product shorten the dependent FMA chain.
// - When the matrices do not fit in shared memory (the sparse-form QP,
//   n = 207, m = 354, is 464 KB a lane) the same kernel reads them from
//   global memory, where they stay L2-resident across iterations: columns
//   coalesce across threads, and A·x̃ is done one warp per row with a shuffle
//   reduction so that those reads coalesce too.
//
// C interface for ctypes: admm_chunk_f32(...) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

template <bool kMatSmem>
__global__ void __launch_bounds__(kMaxThreads)
admm_chunk_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ z0,
                  const float* __restrict__ y0, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo,
                  int n, int m, int lda, int iters, float sigma, float alpha) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float beta = 1.0f - alpha;

  const float* Mg = Minv + static_cast<size_t>(b) * n * n;
  const float* Ag = A + static_cast<size_t>(b) * m * n;

  float* sx = smem;        // x         (n)
  float* sxt = sx + n;     // x̃         (n)
  float* srhs = sxt + n;   // rhs       (n)
  float* sq = srhs + n;    // q         (n)
  float* sz = sq + n;      // z         (m)
  float* sy = sz + m;      // y         (m)
  float* st = sy + m;      // t = ρz − y (m)
  float* sl = st + m;      // l         (m)
  float* su = sl + m;      // u         (m)
  float* srho = su + m;    // ρ         (m)
  float* sirho = srho + m; // 1/ρ       (m)
  float* sM = sirho + m;   // M⁻¹ (n×n), shared-memory variant only
  float* sA = sM + n * n;  // A (m×lda), shared-memory variant only

  for (int j = tid; j < n; j += nt) {
    sx[j] = x0[b * n + j];
    sq[j] = q[b * n + j];
  }
  for (int i = tid; i < m; i += nt) {
    const float r = rho[b * m + i];
    const float zi = z0[b * m + i];
    const float yi = y0[b * m + i];
    sz[i] = zi;
    sy[i] = yi;
    sl[i] = l[b * m + i];
    su[i] = u[b * m + i];
    srho[i] = r;
    sirho[i] = 1.0f / r;
    st[i] = r * zi - yi;
  }
  if constexpr (kMatSmem) {
    for (int k = tid; k < n * n; k += nt) sM[k] = Mg[k];
    for (int k = tid; k < m * n; k += nt) {
      const int i = k / n;
      sA[i * lda + (k - i * n)] = Ag[k];
    }
  }
  __syncthreads();

  const float* Mp = kMatSmem ? sM : Mg;
  const float* Ap = kMatSmem ? sA : Ag;
  const int ldA = kMatSmem ? lda : n;

  for (int it = 0; it < iters; ++it) {
    // rhs = σx − q + Aᵀt   (thread j: column j of A)
    for (int j = tid; j < n; j += nt) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int i = 0;
      for (; i + 3 < m; i += 4) {
        a0 = fmaf(Ap[(i + 0) * ldA + j], st[i + 0], a0);
        a1 = fmaf(Ap[(i + 1) * ldA + j], st[i + 1], a1);
        a2 = fmaf(Ap[(i + 2) * ldA + j], st[i + 2], a2);
        a3 = fmaf(Ap[(i + 3) * ldA + j], st[i + 3], a3);
      }
      for (; i < m; ++i) a0 = fmaf(Ap[i * ldA + j], st[i], a0);
      srhs[j] = sigma * sx[j] - sq[j] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();

    // x̃ = M⁻¹ rhs   (thread j: column j of the symmetric M⁻¹)
    for (int j = tid; j < n; j += nt) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int k = 0;
      for (; k + 3 < n; k += 4) {
        a0 = fmaf(Mp[(k + 0) * n + j], srhs[k + 0], a0);
        a1 = fmaf(Mp[(k + 1) * n + j], srhs[k + 1], a1);
        a2 = fmaf(Mp[(k + 2) * n + j], srhs[k + 2], a2);
        a3 = fmaf(Mp[(k + 3) * n + j], srhs[k + 3], a3);
      }
      for (; k < n; ++k) a0 = fmaf(Mp[k * n + j], srhs[k], a0);
      sxt[j] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();

    // x ← αx̃ + (1−α)x  (x is read only by the rhs stage above)
    for (int j = tid; j < n; j += nt) sx[j] = alpha * sxt[j] + beta * sx[j];

    // z̃ = A x̃, then the relaxation, projection and dual update of row i
    if constexpr (kMatSmem) {
      for (int i = tid; i < m; i += nt) {
        const float* row = sA + i * lda;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int j = 0;
        for (; j + 3 < n; j += 4) {
          a0 = fmaf(row[j + 0], sxt[j + 0], a0);
          a1 = fmaf(row[j + 1], sxt[j + 1], a1);
          a2 = fmaf(row[j + 2], sxt[j + 2], a2);
          a3 = fmaf(row[j + 3], sxt[j + 3], a3);
        }
        for (; j < n; ++j) a0 = fmaf(row[j], sxt[j], a0);
        const float zt = (a0 + a1) + (a2 + a3);
        const float zr = alpha * zt + beta * sz[i];
        const float zn = fminf(fmaxf(zr + sy[i] * sirho[i], sl[i]), su[i]);
        const float yn = sy[i] + srho[i] * (zr - zn);
        sz[i] = zn;
        sy[i] = yn;
        st[i] = srho[i] * zn - yn;
      }
    } else {
      const int lane = tid & 31;
      const int warp = tid >> 5;
      const int nwarps = nt >> 5;
      for (int i = warp; i < m; i += nwarps) {
        const float* row = Ag + static_cast<size_t>(i) * n;
        float acc = 0.f;
        for (int j = lane; j < n; j += 32) acc = fmaf(row[j], sxt[j], acc);
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
          const float zr = alpha * acc + beta * sz[i];
          const float zn = fminf(fmaxf(zr + sy[i] * sirho[i], sl[i]), su[i]);
          const float yn = sy[i] + srho[i] * (zr - zn);
          sz[i] = zn;
          sy[i] = yn;
          st[i] = srho[i] * zn - yn;
        }
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt) xo[b * n + j] = sx[j];
  for (int i = tid; i < m; i += nt) {
    zo[b * m + i] = sz[i];
    yo[b * m + i] = sy[i];
  }
}

size_t vec_bytes(int n, int m) { return sizeof(float) * (4 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m)); }
int row_stride(int n) { return n | 1; }  // odd stride: conflict-free row reads
size_t mat_bytes(int n, int m) {
  return sizeof(float) * (static_cast<size_t>(n) * n + static_cast<size_t>(m) * row_stride(n));
}

int smem_budget() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

}  // namespace

extern "C" {

// 1: matrices in shared memory; 0: matrices read from global memory;
// -1: the vectors alone exceed a block's shared memory (not supported).
int admm_chunk_smem_variant(int n, int m) {
  const size_t budget = static_cast<size_t>(smem_budget());
  if (vec_bytes(n, m) + mat_bytes(n, m) <= budget) return 1;
  if (vec_bytes(n, m) <= budget) return 0;
  return -1;
}

int admm_chunk_f32(const float* Minv, const float* A, const float* q,
                   const float* l, const float* u, const float* rho,
                   const float* x, const float* z, const float* y,
                   float* xo, float* zo, float* yo,
                   int B, int n, int m, int iters, float sigma, float alpha,
                   void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int variant = admm_chunk_smem_variant(n, m);
  if (variant < 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((n > m ? n : m) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int lda = row_stride(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const size_t bytes = vec_bytes(n, m) + mat_bytes(n, m);
    cudaFuncSetAttribute(admm_chunk_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    admm_chunk_kernel<true><<<B, threads, bytes, s>>>(
        Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, n, m, lda, iters, sigma, alpha);
  } else {
    const size_t bytes = vec_bytes(n, m);
    cudaFuncSetAttribute(admm_chunk_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    admm_chunk_kernel<false><<<B, threads, bytes, s>>>(
        Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, n, m, lda, iters, sigma, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
