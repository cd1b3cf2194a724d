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
// Row structure. The solver's declared row structure reaches the kernel as
// (d0, mg): the mg rows of A from row d0 on (a "diag" segment, mg ≤ n) are
// read as their diagonal alone (row d0 + i has one entry, A[d0 + i][i]) and
// applied as elementwise products; the other md = m − mg rows, d0 of them
// before the segment and the rest after it, are dense and are read where
// they stand. On the main path (condensed 3-DoF QP, every state bound
// elided) all 60 rows are the identity control bounds, so A costs no matvec
// at all; with the state bounds kept the row order is [state bounds (dense);
// control bounds (diagonal); facets (dense)] and d0 > 0.
//
// What bounds it on this card. Per lane and iteration the work is one dense
// matvec with M⁻¹ (2n² flops), two with the dense rows (4·md·n) and O(n+m)
// elementwise work; every stage needs the whole previous vector, so an
// iteration is a chain of dependent reductions, one per dense stage. At the
// main-path shape (n = m = 60, all rows diagonal, 50 iterations, 512 lanes)
// one chunk reads 8.7 MB (2.6 µs at 3.35 TB/s) and does 0.215 GFLOP (3.2 µs
// at 67 TFLOP/s); a dense 60×60 A makes it 16 MB and 0.58 GFLOP (8.6 µs).
// Neither is what the run time is made of. Measured on an H100 (700 W,
// gpmpc_tpu_torch/chunk_bench.py): loading the operands takes 3.6 µs, close
// to the bytes bound, and then each iteration ~300 ns, a latency chain of
// barrier, broadcast loads, split dot product, shuffle and row update, with
// four warps a scheduler to overlap.
//
// What the design does about it (the register variant, n ≤ 64 and md ≤ 64):
// - One CTA per lane, one launch per chunk: all `iters` iterations run
//   inside the kernel.
// - M⁻¹ (and the dense rows of A, twice: row-major for A·x̃ and transposed
//   for Aᵀt) are loaded once per chunk from device memory into registers.
//   NP = 64 padded rows, K = 2 threads per row: 128 threads a lane, each
//   thread holding 32 entries of each matrix it keeps. The arrays are
//   indexed only with unrolled compile-time indices, so they stay in
//   registers: ptxas reports 84 registers for the main path's kernel, no
//   spills, and 128 with dense rows, where 8 bytes of the row indexing
//   spill, outside the iteration loop.
// - Shared memory holds only the vectors. A thread reads its entries as
//   float4 broadcasts; thread c of a row group takes float4 chunks c, c+K,
//   c+2K, …, so a warp's distinct chunks are contiguous and never conflict.
// - A row's dot product is split over its K threads, each with eight partial
//   sums, and joined by __shfl_xor_sync: the dependent chain is 4 FMAs and
//   one shuffle instead of 60 FMAs fed by 120 shared loads.
// - The thread group that owns row j of M⁻¹ also owns column j of the
//   diagonal rows and row j of the iterate, so with no dense rows (the main
//   path) an iteration is one matvec, a register-local update and ONE block
//   barrier, on a double-buffered right-hand side. Dense rows add a stage
//   and a barrier each for Aᵀt and A·x̃.
// - Residency: 4 CTAs of 128 threads an SM fit the register file even with
//   dense rows (128 × 128 × 4 = 65,536), so 512 lanes run in one wave on
//   132 SMs. K = 2 is fixed: in the tile sweep (admm_chunk_tiles.cu, timed
//   by gpmpc_tpu_torch/chunk_bench.py; PERF.md) K = 1 was 5% faster on the
//   main path but spilled with dense rows, and K = 4 was 37% slower.
//
// Larger shapes keep the earlier designs: the shared variant copies M⁻¹ and
// the dense rows into dynamic shared memory once per chunk (thread j owns
// element j of each stage), and the global variant, for matrices beyond
// shared memory (the sparse-form golden QP, n = 207, m = 354, is 464 KB a
// lane), reads them from global memory, with A·x̃ done one warp per row:
// L2-resident for a few lanes, streamed from device memory every iteration
// for hundreds (512 lanes hold 237 MB). One CTA a lane leaves most of the
// card idle when the lanes are few, as the four lanes of a GP pretraining
// run are; PERF.md has the times. `admm_chunk_variant` picks by shape.
//
// Tensor cores and TMA are not the tool. Each lane's matrix meets one vector
// per iteration: a chain of GEMVs with no reuse to feed an MMA tile, and the
// port keeps f32 with TF32 off. The one load of the matrices per chunk is
// itself the bytes bound, with no compute to hide behind, so an
// asynchronous copy has nothing to overlap with.
//
// C interface for ctypes: admm_chunk_f32(...) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kUnsupported = -1, kGlobal = 0, kShared = 1, kRegister = 2 };

struct Lane {
  int n, m, d0, mg, iters;
  float sigma, alpha;
};

// dense row r (of md) → its row of A: the diagonal segment's mg rows, which
// start at row d0, are skipped
struct Rows {
  int d0, mg;
  __device__ int at(int r) const { return r < d0 ? r : r + mg; }
};

// one iteration's projection and dual update of a row; returns the new t
__device__ __forceinline__ float row_update(float zt, float& z, float& y, float l,
                                            float u, float r, float ir, float alpha,
                                            float beta) {
  const float zr = alpha * zt + beta * z;
  const float zn = fminf(fmaxf(zr + y * ir, l), u);
  y = y + r * (zr - zn);
  z = zn;
  return r * zn - y;
}

// ---------------------------------------------------------------------------
// Register variant: thread (g, c) = (tid / K, tid % K) holds row g of each
// kept matrix at columns 4(c + K·s) + e, s < C/4, e < 4.

template <int NP, int K>
struct Tile {
  static constexpr int C = NP / K;  // entries of a row a thread holds
  static constexpr int S = C / 4;   // float4 chunks
  static_assert(C % 8 == 0 && 32 % K == 0, "tile");

  __device__ static int col(int c, int s, int e) { return 4 * (c + K * s) + e; }

  // R[g, :] from the `rows` rows that `map` picks of a row-major matrix with
  // `cols` columns and leading dimension ld; zero outside it. The transposed
  // read takes R[g, k] = row k, column g. Rows read as float4 where the
  // layout allows (cols and ld multiples of 4, M 16-byte aligned: n = 60 on
  // the main path).
  template <bool kTransposed>
  __device__ static void load(float (&R)[C], const float* __restrict__ M, int rows,
                              int cols, int ld, int g, int c, Rows map) {
    const bool vec = !kTransposed && cols % 4 == 0 && ld % 4 == 0 &&
                     (reinterpret_cast<unsigned long long>(M) & 15) == 0;
    if (vec) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = col(c, s, 0);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < rows && k < cols)
          v = *reinterpret_cast<const float4*>(M + static_cast<size_t>(map.at(g)) * ld + k);
        R[4 * s + 0] = v.x; R[4 * s + 1] = v.y; R[4 * s + 2] = v.z; R[4 * s + 3] = v.w;
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = col(c, s, e);
        float v = 0.f;
        if (kTransposed) {
          if (k < rows && g < cols) v = M[static_cast<size_t>(map.at(k)) * ld + g];
        } else {
          if (g < rows && k < cols) v = M[static_cast<size_t>(map.at(g)) * ld + k];
        }
        R[4 * s + e] = v;
      }
    }
  }

  // Σ_k R[g, k] v[k] over the K threads of the group (every thread gets it),
  // with eight partial sums
  __device__ static float dot(const float (&R)[C], const float* v, int c) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 w = v4[c + K * s];
      float* h = a + 4 * (s & 1);
      h[0] = fmaf(R[4 * s + 0], w.x, h[0]);
      h[1] = fmaf(R[4 * s + 1], w.y, h[1]);
      h[2] = fmaf(R[4 * s + 2], w.z, h[2]);
      h[3] = fmaf(R[4 * s + 3], w.w, h[3]);
    }
    float acc = ((a[0] + a[4]) + (a[1] + a[5])) + ((a[2] + a[6]) + (a[3] + a[7]));
#pragma unroll
    for (int off = 1; off < K; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
    return acc;
  }
};

constexpr int kRowThreads = 2;  // threads per row of a tile (K)

template <int NP, int K, bool kDense>
__global__ void __launch_bounds__(NP * K, (kDense && K > 2) ? 1 : 4)
admm_chunk_reg(const float* __restrict__ Minv, const float* __restrict__ A,
               const float* __restrict__ q, const float* __restrict__ l,
               const float* __restrict__ u, const float* __restrict__ rho,
               const float* __restrict__ x0, const float* __restrict__ z0,
               const float* __restrict__ y0, float* __restrict__ xo,
               float* __restrict__ zo, float* __restrict__ yo, Lane p) {
  using T = Tile<NP, K>;
  __shared__ __align__(16) float s_rhs[2][NP];  // double-buffered M⁻¹ operand
  __shared__ __align__(16) float s_xt[NP];      // x̃ for the dense rows
  __shared__ __align__(16) float s_t[NP];       // t of the dense rows
  __shared__ float s_lu[kDense ? 2 : 1][NP];    // bounds of the dense rows

  const int b = blockIdx.x;
  const int g = threadIdx.x / K;
  const int c = threadIdx.x % K;
  const int n = p.n, m = p.m, d0 = p.d0, mg = p.mg, md = m - mg;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, sigma = p.sigma;
  const float* Ab = A + static_cast<size_t>(b) * m * n;
  const Rows dense{d0, mg};

  float Mr[T::C];
  T::template load<false>(Mr, Minv + static_cast<size_t>(b) * n * n, n, n, n, g, c, Rows{0, 0});
  float Ar[kDense ? T::C : 1], ATr[kDense ? T::C : 1];
  if constexpr (kDense) {
    T::template load<false>(Ar, Ab, md, n, n, g, c, dense);   // dense row g
    T::template load<true>(ATr, Ab, md, n, n, g, c, dense);   // column g of the dense rows
  }

  // row g of the iterate; diagonal row d0 + g (column g); dense row g of md
  const bool own_x = g < n, own_d = g < mg, own_D = kDense && g < md;
  // this group's diagonal row and dense row among the B·m rows (recomputed
  // where they are needed: the dense tiles leave no register to hold them)
  auto diag_row = [&] { return b * m + d0 + g; };
  auto dense_row = [&] { return b * m + dense.at(g); };
  float xg = own_x ? x0[b * n + g] : 0.f;
  const float qg = own_x ? q[b * n + g] : 0.f;
  float zd = 0.f, yd = 0.f, ld = 0.f, ud = 0.f, rd = 1.f, ird = 1.f, dd = 0.f, td = 0.f;
  if (own_d) {
    const int id = diag_row();
    zd = z0[id]; yd = y0[id]; ld = l[id]; ud = u[id]; rd = rho[id];
    ird = 1.0f / rd;
    dd = Ab[static_cast<size_t>(d0 + g) * n + g];
    td = rd * zd - yd;
  }
  float zD = 0.f, yD = 0.f, rD = 1.f, irD = 1.f;
  if (own_D) {
    const int iD = dense_row();
    zD = z0[iD]; yD = y0[iD]; rD = rho[iD];
    irD = 1.0f / rD;
  }
  for (int k = threadIdx.x; k < NP; k += NP * K) {
    s_rhs[0][k] = 0.f; s_rhs[1][k] = 0.f; s_xt[k] = 0.f; s_t[k] = 0.f;
  }
  __syncthreads();
  if (kDense && c == 0 && own_D) {
    s_t[g] = rD * zD - yD;
    s_lu[0][g] = l[dense_row()];  // kept out of registers: the dense
    s_lu[1][g] = u[dense_row()];  // tiles leave none to spare
  }

  for (int it = 0; it < p.iters; ++it) {
    float* rhs = s_rhs[it & 1];
    // rhs = σx − q + Aᵀt   (group g: column g)
    float at = 0.f;
    if constexpr (kDense) {
      __syncthreads();  // s_t of the previous stage
      at = T::dot(ATr, s_t, c);
    }
    if (own_d) at = fmaf(dd, td, at);
    if (c == 0 && own_x) rhs[g] = sigma * xg - qg + at;
    __syncthreads();

    // x̃ = M⁻¹ rhs   (group g: row g), then the diagonal row g
    const float xt = T::dot(Mr, rhs, c);
    if (own_x) xg = alpha * xt + beta * xg;
    if (own_d) td = row_update(dd * xt, zd, yd, ld, ud, rd, ird, alpha, beta);

    if constexpr (kDense) {
      // z̃ = Ad x̃   (group g: dense row g)
      if (c == 0 && own_x) s_xt[g] = xt;
      __syncthreads();
      const float zt = T::dot(Ar, s_xt, c);
      if (own_D) {
        const float tD = row_update(zt, zD, yD, s_lu[0][g], s_lu[1][g], rD, irD, alpha, beta);
        if (c == 0) s_t[g] = tD;
      }
    }
  }

  if (c == 0) {
    if (own_x) xo[b * n + g] = xg;
    if (own_d) { zo[diag_row()] = zd; yo[diag_row()] = yd; }
    if (own_D) { zo[dense_row()] = zD; yo[dense_row()] = yD; }
  }
}

// ---------------------------------------------------------------------------
// Shared- and global-memory variants: thread j owns element j of each stage.
// The vectors lie in shared memory in A's row order. The shared variant
// copies the md dense rows, compacted, beside M⁻¹; the global one reads them
// where they stand in A.

template <bool kMatSmem>
__global__ void __launch_bounds__(kMaxThreads)
admm_chunk_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ z0,
                  const float* __restrict__ y0, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo, Lane p, int lda) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = p.n, m = p.m, d0 = p.d0, mg = p.mg, md = m - mg;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, sigma = p.sigma;
  const Rows dense{d0, mg};

  const float* Mg = Minv + static_cast<size_t>(b) * n * n;
  const float* Ab = A + static_cast<size_t>(b) * m * n;

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
  float* sdg = sirho + m;  // diagonal of the rows d0 .. d0+mg (mg)
  float* sM = sdg + mg;    // M⁻¹ (n×n), shared-memory variant only
  float* sA = sM + n * n;  // dense rows (md×lda), shared-memory variant only

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
  for (int i = tid; i < mg; i += nt) sdg[i] = Ab[static_cast<size_t>(d0 + i) * n + i];
  if constexpr (kMatSmem) {
    for (int k = tid; k < n * n; k += nt) sM[k] = Mg[k];
    for (int k = tid; k < md * n; k += nt) {
      const int r = k / n;
      const int j = k - r * n;
      sA[r * lda + j] = Ab[static_cast<size_t>(dense.at(r)) * n + j];
    }
  }
  __syncthreads();

  const float* Mp = kMatSmem ? sM : Mg;
  // dense row r lies at Ap + (r + shift)·ldA and has its t at st[r + tshift]:
  // rows before the diagonal segment with both shifts 0, rows after it with
  // tshift = mg, and shift = mg too where A is read in place
  const float* Ap = kMatSmem ? sA : Ab;
  const int ldA = kMatSmem ? lda : n;
  const int after = kMatSmem ? 0 : mg;

  for (int it = 0; it < p.iters; ++it) {
    // rhs = σx − q + Aᵀt   (thread j: column j of the dense rows, diagonal entry j)
    for (int j = tid; j < n; j += nt) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int r1 = part == 0 ? d0 : md;
        const float* Aj = Ap + static_cast<size_t>(part == 0 ? 0 : after) * ldA + j;
        const float* tp = st + (part == 0 ? 0 : mg);
        int r = part == 0 ? 0 : d0;
        for (; r + 3 < r1; r += 4) {
          a0 = fmaf(Aj[(r + 0) * ldA], tp[r + 0], a0);
          a1 = fmaf(Aj[(r + 1) * ldA], tp[r + 1], a1);
          a2 = fmaf(Aj[(r + 2) * ldA], tp[r + 2], a2);
          a3 = fmaf(Aj[(r + 3) * ldA], tp[r + 3], a3);
        }
        for (; r < r1; ++r) a0 = fmaf(Aj[r * ldA], tp[r], a0);
      }
      float at = (a0 + a1) + (a2 + a3);
      if (j < mg) at = fmaf(sdg[j], st[d0 + j], at);
      srhs[j] = sigma * sx[j] - sq[j] + at;
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
    for (int k = tid; k < mg; k += nt) {
      const int i = d0 + k;
      st[i] = row_update(sdg[k] * sxt[k], sz[i], sy[i], sl[i], su[i], srho[i],
                         sirho[i], alpha, beta);
    }
    if constexpr (kMatSmem) {
      for (int r = tid; r < md; r += nt) {
        const float* row = sA + r * lda;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int j = 0;
        for (; j + 3 < n; j += 4) {
          a0 = fmaf(row[j + 0], sxt[j + 0], a0);
          a1 = fmaf(row[j + 1], sxt[j + 1], a1);
          a2 = fmaf(row[j + 2], sxt[j + 2], a2);
          a3 = fmaf(row[j + 3], sxt[j + 3], a3);
        }
        for (; j < n; ++j) a0 = fmaf(row[j], sxt[j], a0);
        const int i = dense.at(r);
        st[i] = row_update((a0 + a1) + (a2 + a3), sz[i], sy[i], sl[i], su[i],
                           srho[i], sirho[i], alpha, beta);
      }
    } else {
      const int lane = tid & 31;
      const int warp = tid >> 5;
      const int nwarps = nt >> 5;
      for (int r = warp; r < md; r += nwarps) {
        const int i = dense.at(r);
        const float* row = Ab + static_cast<size_t>(i) * n;
        float acc = 0.f;
        for (int j = lane; j < n; j += 32) acc = fmaf(row[j], sxt[j], acc);
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        if (lane == 0)
          st[i] = row_update(acc, sz[i], sy[i], sl[i], su[i], srho[i], sirho[i],
                             alpha, beta);
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

size_t vec_bytes(int n, int m, int mg) {
  return sizeof(float) * (4 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m) + mg);
}
int row_stride(int n) { return n | 1; }  // odd stride: conflict-free row reads
size_t mat_bytes(int n, int md) {
  return sizeof(float) * (static_cast<size_t>(n) * n + static_cast<size_t>(md) * row_stride(n));
}

// Per-device state, read or set once: the opt-in shared memory of a block,
// and whether each dynamic-shared-memory kernel has been allowed all of it.
int g_smem_optin[kMaxDevices];
bool g_smem_set[kMaxDevices][2];

int smem_budget(int dev) {
  if (g_smem_optin[dev] == 0) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    g_smem_optin[dev] = optin;
  }
  return g_smem_optin[dev];
}

template <bool kMatSmem>
void allow_smem(int dev) {
  if (!g_smem_set[dev][kMatSmem]) {
    cudaFuncSetAttribute(admm_chunk_kernel<kMatSmem>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_budget(dev));
    g_smem_set[dev][kMatSmem] = true;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, const float*,
                         const float*, float*, float*, float*, Lane);

// the register kernel instance for a shape: the tile's padded rows and
// whether it keeps dense rows; *threads gets its block size
template <int K>
KernelFn register_kernel(int n, int md, int* threads) {
  const bool small = n <= 32 && md <= 32;
  *threads = (small ? 32 : 64) * K;
  if (md > 0) return small ? &admm_chunk_reg<32, K, true> : &admm_chunk_reg<64, K, true>;
  return small ? &admm_chunk_reg<32, K, false> : &admm_chunk_reg<64, K, false>;
}

int variant_for(int n, int m, int mg, int device) {
  const int md = m - mg;
  if (n <= 0 || m <= 0 || mg < 0 || mg > m || mg > n) return kUnsupported;
  if (device < 0 || device >= kMaxDevices) return kUnsupported;
  if (n <= 64 && md <= 64) return kRegister;
  const size_t budget = static_cast<size_t>(smem_budget(device));
  if (vec_bytes(n, m, mg) + mat_bytes(n, md) <= budget) return kShared;
  if (vec_bytes(n, m, mg) <= budget) return kGlobal;
  return kUnsupported;
}

// one chunk launch, the register variant tiled with K threads per row
template <int K>
int launch_chunk(const float* Minv, const float* A, const float* q, const float* l,
                 const float* u, const float* rho, const float* x, const float* z,
                 const float* y, float* xo, float* zo, float* yo,
                 int B, int n, int m, int d0, int mg, int iters, float sigma, float alpha,
                 int device, void* stream) {
  if (B <= 0 || d0 < 0 || d0 + mg > m) return static_cast<int>(cudaErrorInvalidValue);
  const int variant = variant_for(n, m, mg, device);
  if (variant == kUnsupported) return static_cast<int>(cudaErrorInvalidValue);
  const Lane p{n, m, d0, mg, iters, sigma, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int md = m - mg;
  if (variant == kRegister) {
    int threads = 0;
    const KernelFn kernel = register_kernel<K>(n, md, &threads);
    kernel<<<B, threads, 0, s>>>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p);
    return static_cast<int>(cudaGetLastError());
  }
  int threads = ((n > m ? n : m) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int lda = row_stride(n);
  if (variant == kShared) {
    allow_smem<true>(device);
    admm_chunk_kernel<true><<<B, threads, vec_bytes(n, m, mg) + mat_bytes(n, md), s>>>(
        Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p, lda);
  } else {
    allow_smem<false>(device);
    admm_chunk_kernel<false><<<B, threads, vec_bytes(n, m, mg), s>>>(
        Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p, lda);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 2: register variant; 1: matrices in shared memory; 0: matrices read from
// global memory; -1: the vectors alone exceed a block's shared memory, or
// the declared diagonal rows outnumber the columns (not supported). The
// diagonal segment's row offset does not enter the choice.
int admm_chunk_variant(int n, int m, int mg, int device) {
  return variant_for(n, m, mg, device);
}

// Minv (B,n,n), A (B,m,n), q/x (B,n), l/u/rho/z/y (B,m); outputs xo (B,n),
// zo/yo (B,m). Rows d0 .. d0+mg of A are read as their diagonal alone.
// `device` is the current CUDA device.
int admm_chunk_f32(const float* Minv, const float* A, const float* q, const float* l,
                   const float* u, const float* rho, const float* x, const float* z,
                   const float* y, float* xo, float* zo, float* yo,
                   int B, int n, int m, int d0, int mg, int iters, float sigma, float alpha,
                   int device, void* stream) {
  return launch_chunk<kRowThreads>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, n, m,
                                   d0, mg, iters, sigma, alpha, device, stream);
}

}  // extern "C"
