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
// Four variants serve the shapes; `admm_chunk_variant` picks by shape and
// lane count. Per lane and iteration the work is one dense matvec with M⁻¹
// (2n² flops), two with the dense rows (4·md·n) and O(n+m) elementwise work;
// every stage needs the whole previous vector, so an iteration is a chain of
// dependent reductions. The device-memory bound (each operand read once a
// chunk) and the f32 rate are far below every measured time: what costs is
// what an iteration re-reads and how long its chain is. All times below are
// CUDA-graph replays on an NVIDIA H100 80GB HBM3, 700 W, from
// gpmpc_tpu_torch/chunk_bench.py and chip_smoke.py; PERF.md has the tables.
//
// 1. Register (n ≤ 64 and md ≤ 64: the main and RTI paths). Bound by the
//    latency of the chain: operands load in 3.6 µs, close to the bytes
//    bound, and then an iteration takes ~0.30 µs of barrier, broadcast
//    loads, split dot product, shuffle and row update.
//    - One CTA a lane, one launch a chunk. M⁻¹ (and the dense rows of A,
//      twice: row-major for A·x̃ and transposed for Aᵀt) are loaded once a
//      chunk into registers: NP = 64 padded rows, K = 2 threads a row, 128
//      threads a lane, 32 entries of each kept matrix a thread, indexed only
//      with unrolled compile-time indices (ptxas: 84 registers on the main
//      path, 128 with dense rows, 8 bytes spilt outside the loop).
//    - Shared memory holds only the vectors, read as float4 broadcasts;
//      thread c of a row group takes chunks c, c+K, …, so a warp's distinct
//      chunks are contiguous and never conflict.
//    - A row's dot product is split over its K threads, each with eight
//      partial sums, and joined by __shfl_xor_sync.
//    - The group that owns row j of M⁻¹ also owns column j of the diagonal
//      rows and row j of the iterate, so with no dense rows an iteration is
//      one matvec, a register-local update and ONE block barrier on a
//      double-buffered right-hand side; dense rows add a stage and a barrier
//      each. Four CTAs an SM fit the register file, so 512 lanes run in one
//      wave. K = 2 is fixed: in the tile sweep K = 1 was 5% faster on the main
//      path but spilled with dense rows, and K = 4 was 37% slower.
//
// 2. Shared (the lane fits one block's shared memory: the condensed QP that
//    keeps its state bounds, n = 60, m = 200, and the 6-DoF QP with cone
//    facets, m = 380). Bound by shared-memory bandwidth: with four lanes an
//    SM the two passes over A's 140 dense rows are 69 KB a lane and
//    iteration, 2,200 clocks an SM at 128 bytes a clock, and the vectors and
//    row state add about half as much again; the chain (a 35-row column walk,
//    three rounds of row dot products, three block barriers) fits inside it.
//    - M⁻¹ lies in registers as in variant 1 (256 threads, 4 a row), which
//      takes a third of the traffic out of shared memory.
//    - A's dense rows lie in shared memory once, zero-padded to whole rounds
//      of K float4 chunks, and serve both directions. A·x̃: a row's dot
//      product is split over K = 4 threads that read 64 contiguous bytes at
//      a time (the stride puts the two rows of a quarter warp in different
//      banks), with x̃'s chunks read once a stage into registers. Aᵀt: a
//      quarter warp reads 8 neighbouring float4 of one row (128 bytes, every
//      bank once) and the four quarters take four rows side by side, joined
//      by two shuffles: 4 columns a thread and load instead of 1.
//    - A group takes K rows in turn and then thread c updates the c-th of
//      them: the projection and dual update run once for K rows.
//    - The sweep (T = 128, 256, 512 threads × K = 4, 8, 16) has T = 256, K = 4
//      best at n = 60, m = 200: 0.094 ms for 25 iterations, against 0.108 for
//      the one-thread-a-row design before it; T = 512 is 15% faster at
//      m = 380 and 45% slower at m = 200. The stage probe (chunk_bench.py
//      --sweep stages) splits the 0.098 ms of its build into 0.017 of load,
//      0.018 of barriers and loop control, 0.029 for the row dot products,
//      0.017 for the column walk, 0.007 for M⁻¹ and 0.008 for the updates:
//      the two passes over A are 60% of an iteration.
//      The declared zero blocks of a "blt" segment are read like any entry.
//
// 3. Cluster (a lane beyond one block: the sparse-form QP, n = 207, m = 354,
//    758 KB a lane). The TPU kernel pins a lane's matrices in fast memory
//    for the whole chunk; here the lane is split over the C CTAs of a
//    thread-block cluster, each holding a contiguous slice of M⁻¹'s rows and
//    of A's dense rows in its shared memory, with the z, y, l, u, ρ entries
//    of those rows. Bound by barrier latency when lanes are few (two cluster
//    barriers and two block barriers an iteration, ~3.7 µs an iteration at
//    4 lanes) and by shared-memory bandwidth when they are many (512 lanes
//    re-read 9.7 GB a chunk).
//    - (a) each CTA forms its partial of Aᵀt over its own rows, as in
//      variant 2, adds its share of the diagonal segment, and all sum the C
//      partials through distributed shared memory in rank order, so every
//      CTA holds the same rhs bit for bit; (b) each CTA computes its rows of
//      x̃ = M⁻¹·rhs (K = 8 threads a row) and writes them into every CTA's
//      copy of x̃; (c) each CTA computes z̃ for its own rows and updates them
//      locally. x and q are kept whole in every CTA.
//    - The slices are copied with plain 4-byte loads, coalesced along a row:
//      rows of 207 floats are not 16-byte aligned, so neither cp.async.bulk
//      nor float4 loads apply to them, and the copy happens once a chunk.
//    - C is the smallest cluster that holds the lane (4 at n = 207), doubled
//      to 8 while a CTA takes more than a third of an SM's shared memory, so
//      that three resident CTAs hide each other's barriers, and to 16 (a
//      non-portable size) while the launch would leave most SMs idle. In the
//      sweep (C = 4, 8, 16 × T = 256, 512 × K = 8, 16; T = 256, K = 8 here) at
//      4 lanes C = 4 takes 0.117 ms for 25 iterations, C = 8 0.099 and C = 16
//      0.098 (2.44 for the global variant before it, 0.87 for a cuBLAS bmm
//      chain); at 512 lanes C = 8 takes 1.58 ms, C = 4 2.21 and C = 16 3.14
//      (5.83 and 4.7). T = 512 wins by 10% at C = 4 and loses 2× at C = 8,
//      512 lanes; K = 16 loses everywhere. ptxas: 80 registers, no spill.
//    - The stage probe at 4 lanes (0.121 ms in its build): the two cluster
//      barriers cost 0.035, the remote sum 0.018, all arithmetic 0.031, and
//      0.038 is left with everything out; at 512 lanes (1.86 ms) the
//      arithmetic is 0.73, the barriers 0.33, the remote sum 0.13, the load
//      0.19. What an iteration exchanges and waits for costs as much as
//      what it computes.
//    - A cluster the card cannot place (cudaOccupancyMaxActiveClusters
//      answers 0) is refused with cudaErrorLaunchOutOfResources.
//
// 4. Global (a lane no cluster of 16 holds). The vectors lie in shared
//    memory and the matrices are read from global memory every iteration,
//    one CTA a lane; bound by L2 and device-memory latency and bandwidth.
//    It is the first design of this port, kept for such lanes alone.
//
// Tensor cores and TMA are not the tool. Each lane's matrix meets one vector
// per iteration: a chain of GEMVs with no reuse to feed an MMA tile, and the
// port keeps f32 with TF32 off. The one load of the matrices per chunk has
// no compute to hide behind, so an asynchronous copy has nothing to overlap
// with.
//
// C interface for ctypes: admm_chunk_f32(...) returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kUnsupported = -1, kGlobal = 0, kShared = 1, kRegister = 2, kCluster = 3 };

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
// Row-split kernel: the shared variant (one CTA a lane) and the cluster
// variant (a lane's rows split over the C CTAs of a thread-block cluster).
// Every matrix entry lies in shared memory (M⁻¹ in registers where n ≤ 64)
// for the whole chunk. Rows are stored zero-padded at stride ld, so that a
// row's dot product reads float4 chunks and a column walk reads neighbouring
// words.

// Stage probe. No profiler reaches inside a kernel on every machine, so
// csrc/admm_chunk_probe.cu builds this file with ADMM_CHUNK_PROBE defined:
// the row-split kernel then leaves out the stages named in Split::skip, and
// what a stage costs is the time that goes with it (the results are then
// wrong, and only timed). Without the macro the tests fold to false.
#ifdef ADMM_CHUNK_PROBE
#define PROBE_SKIP(sp, bit) (((sp).skip & (bit)) != 0)
#else
#define PROBE_SKIP(sp, bit) false
#endif
enum Stage {
  kSkipColumnWalk = 1,  // (a) the reads of A for Aᵀt
  kSkipMinvDots = 2,    // (b) the dot products with M⁻¹
  kSkipRowDots = 4,     // (c) the dot products with A's rows
  kSkipRowUpdates = 8,  // (c) projection and dual update, dense and diagonal rows
  kSkipRemoteSum = 16,  // cluster: the C − 1 remote partials of the rhs
  kSkipClusterSync = 32 // cluster: block barriers in place of cluster barriers
};

struct Split {
  int C;   // CTAs a lane: 1 for the shared variant
  int K;   // threads that share a row's dot product
  int ld;  // row stride in shared memory, floats: a multiple of 4K, ≥ n
  int lv;  // length of the zero-padded vectors
  int nc, mc, kc;  // rows of M⁻¹, dense rows and diagonal rows a CTA owns at most
  int minv_reg;    // M⁻¹ in registers (one CTA a lane, n ≤ 64)
#ifdef ADMM_CHUNK_PROBE
  int skip;        // stages the probe build leaves out (Stage bits)
#endif

  __host__ __device__ int floats() const {
    return (minv_reg ? 0 : nc * ld) + mc * ld + (C > 1 ? 5 : 4) * lv + 7 * mc + 8 * kc;
  }
};

// the float4 chunks c, c+K, … of a zero-padded vector that thread c of a row
// group meets in every row: read once a stage, kept in registers
template <int CH>
__device__ __forceinline__ void load_chunks(float4 (&v)[CH], const float* vec, int c, int K,
                                            int ch) {
  const float4* v4 = reinterpret_cast<const float4*>(vec);
#pragma unroll
  for (int i = 0; i < CH; ++i) v[i] = i < ch ? v4[c + K * i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// this thread's share of Σ_k row[k]·v[k]: its ch chunks of a zero-padded row
template <int CH>
__device__ __forceinline__ float row_partial(const float* row, const float4 (&v)[CH], int c,
                                             int K, int ch) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (i < ch) {
      const float4 w = r4[c + K * i];
      a0 = fmaf(w.x, v[i].x, a0);
      a1 = fmaf(w.y, v[i].y, a1);
      a2 = fmaf(w.z, v[i].z, a2);
      a3 = fmaf(w.w, v[i].w, a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// sum over the K neighbouring threads of a row group (K a power of two ≤ 32)
__device__ __forceinline__ float join(float acc, int K) {
  for (int off = 1; off < K; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// Registers: four lanes of 256 threads an SM with M⁻¹ in registers (64 a
// thread); without it three CTAs an SM, which is what the shared memory of a
// lane split over 8 CTAs leaves room for (85 a thread).
template <int T, bool kMinvReg, bool kClustered>
__global__ void __launch_bounds__(T, (kMinvReg ? 1024 : 768) / T)
admm_chunk_rows(const float* __restrict__ Minv, const float* __restrict__ A,
                const float* __restrict__ q, const float* __restrict__ l,
                const float* __restrict__ u, const float* __restrict__ rho,
                const float* __restrict__ x0, const float* __restrict__ z0,
                const float* __restrict__ y0, float* __restrict__ xo,
                float* __restrict__ zo, float* __restrict__ yo, Lane p, Split sp) {
  static_assert(!(kMinvReg && kClustered), "M⁻¹ in registers: one CTA a lane");
  constexpr int KM = T / 64;            // threads per row of the register-held M⁻¹
  constexpr int CH = kMinvReg ? 4 : 8;  // chunks of a row a thread meets, at most
  using TM = Tile<64, KM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n = p.n, m = p.m, d0 = p.d0, mg = p.mg, md = m - mg;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, sigma = p.sigma;
  const Rows dense{d0, mg};
  const int ld = sp.ld, lv = sp.lv, K = sp.K;

  int rank = 0;
  if constexpr (kClustered) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / sp.C;
  // this CTA's rows of M⁻¹, of the dense rows and of the diagonal segment
  const int n0 = min(rank * sp.nc, n), nc = min(sp.nc, n - n0);
  const int r0 = min(rank * sp.mc, md), mc = min(sp.mc, md - r0);
  const int k0 = min(rank * sp.kc, mg), kc = min(sp.kc, mg - k0);

  const float* Mg = Minv + static_cast<size_t>(b) * n * n;
  const float* Ab = A + static_cast<size_t>(b) * m * n;

  float* sM = smem;                                // own rows of M⁻¹ (nc × ld)
  float* sA = sM + (kMinvReg ? 0 : sp.nc * ld);    // own dense rows (mc × ld)
  float* s_rhs = sA + sp.mc * ld;                  // rhs, whole (lv)
  float* s_xt = s_rhs + lv;                        // x̃, whole (lv)
  float* s_x = s_xt + lv;                          // x, whole (lv)
  float* s_q = s_x + lv;                           // q, whole (lv)
  float* s_part = s_q + lv;                        // own partial of Aᵀt (lv), cluster only
  float* sz = s_part + (kClustered ? lv : 0);      // own dense rows: z y l u ρ 1/ρ t
  float* sy = sz + sp.mc;
  float* sl = sy + sp.mc;
  float* su = sl + sp.mc;
  float* srho = su + sp.mc;
  float* sirho = srho + sp.mc;
  float* st = sirho + sp.mc;
  float* dz = st + sp.mc;                          // own diagonal rows: z y l u ρ 1/ρ t d
  float* dy = dz + sp.kc;
  float* dl = dy + sp.kc;
  float* du = dl + sp.kc;
  float* drho = du + sp.kc;
  float* dirho = drho + sp.kc;
  float* dt = dirho + sp.kc;
  float* dd = dt + sp.kc;

  // ---- one load per chunk. Rows of n floats are not 16-byte aligned in
  // general (n = 207), so the copy is plain 4-byte loads, coalesced along a
  // row, into the padded layout.
  float Mr[kMinvReg ? TM::C : 1];
  if constexpr (kMinvReg) {
    TM::template load<false>(Mr, Mg, n, n, n, tid / KM, tid % KM, Rows{0, 0});
  } else {
    for (int k = tid; k < nc * ld; k += T) {
      const int r = k / ld, j = k - r * ld;
      sM[k] = j < n ? Mg[static_cast<size_t>(n0 + r) * n + j] : 0.f;
    }
  }
  for (int k = tid; k < mc * ld; k += T) {
    const int r = k / ld, j = k - r * ld;
    sA[k] = j < n ? Ab[static_cast<size_t>(dense.at(r0 + r)) * n + j] : 0.f;
  }
  for (int k = tid; k < lv; k += T) {
    s_rhs[k] = 0.f;
    s_xt[k] = 0.f;
    s_x[k] = k < n ? x0[b * n + k] : 0.f;
    s_q[k] = k < n ? q[b * n + k] : 0.f;
    if constexpr (kClustered) s_part[k] = 0.f;
  }
  for (int r = tid; r < mc; r += T) {
    const int i = b * m + dense.at(r0 + r);
    const float rr = rho[i], zi = z0[i], yi = y0[i];
    sz[r] = zi; sy[r] = yi; sl[r] = l[i]; su[r] = u[i];
    srho[r] = rr; sirho[r] = 1.0f / rr; st[r] = rr * zi - yi;
  }
  for (int k = tid; k < kc; k += T) {
    const int i = b * m + d0 + k0 + k;
    const float rr = rho[i], zi = z0[i], yi = y0[i];
    dz[k] = zi; dy[k] = yi; dl[k] = l[i]; du[k] = u[i];
    drho[k] = rr; dirho[k] = 1.0f / rr; dt[k] = rr * zi - yi;
    dd[k] = Ab[static_cast<size_t>(d0 + k0 + k) * n + (k0 + k)];
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  // Aᵀt: a quarter warp reads 8 neighbouring float4 of one row (128 bytes,
  // every bank once); the 4 quarters of a warp take rows r, r+1, r+2, r+3
  const int part = lane >> 3, q4 = (n + 3) / 4, sets = (q4 + 7) / 8, ld4 = ld / 4;
  // row dot products: group g of K threads, thread c its chunks c, c+K, …
  const int G = T / K, g = tid / K, c = tid - g * K, ch = (n + 4 * K - 1) / (4 * K);

  for (int it = 0; it < p.iters; ++it) {
    // (a) this CTA's share of Aᵀt over its own dense rows and diagonal rows
    for (int set = warp; set < sets; set += T / 32) {
      const int jj = set * 8 + (lane & 7);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jj < q4 && !PROBE_SKIP(sp, kSkipColumnWalk)) {
        const float4* col = reinterpret_cast<const float4*>(sA) + jj;
#pragma unroll 4
        for (int r = part; r < mc; r += 4) {
          const float4 w = col[r * ld4];
          const float t = st[r];
          acc.x = fmaf(w.x, t, acc.x);
          acc.y = fmaf(w.y, t, acc.y);
          acc.z = fmaf(w.z, t, acc.z);
          acc.w = fmaf(w.w, t, acc.w);
        }
      }
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        acc.x += __shfl_xor_sync(kFull, acc.x, off);
        acc.y += __shfl_xor_sync(kFull, acc.y, off);
        acc.z += __shfl_xor_sync(kFull, acc.z, off);
        acc.w += __shfl_xor_sync(kFull, acc.w, off);
      }
      if (part == 0 && jj < q4) {
        float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * jj + e - k0;
          if (k >= 0 && k < kc) a[e] = fmaf(dd[k], dt[k], a[e]);
        }
        if constexpr (kClustered) {
          reinterpret_cast<float4*>(s_part)[jj] = make_float4(a[0], a[1], a[2], a[3]);
        } else {
          const float4 xv = reinterpret_cast<const float4*>(s_x)[jj];
          const float4 qv = reinterpret_cast<const float4*>(s_q)[jj];
          reinterpret_cast<float4*>(s_rhs)[jj] =
              make_float4(sigma * xv.x - qv.x + a[0], sigma * xv.y - qv.y + a[1],
                          sigma * xv.z - qv.z + a[2], sigma * xv.w - qv.w + a[3]);
        }
      }
    }
    if constexpr (kClustered) {
      // rhs = σx − q + the C partials, summed in rank order in every CTA
      cg::cluster_group cluster = cg::this_cluster();
      if (PROBE_SKIP(sp, kSkipClusterSync)) __syncthreads();
      else cluster.sync();
      for (int j = tid; j < n; j += T) {
        float s = 0.f;
        if (PROBE_SKIP(sp, kSkipRemoteSum)) {
          s = s_part[j];
        } else {
#pragma unroll 4
          for (int cc = 0; cc < sp.C; ++cc) s += cluster.map_shared_rank(s_part, cc)[j];
        }
        s_rhs[j] = sigma * s_x[j] - s_q[j] + s;
      }
    }
    __syncthreads();

    // (b) x̃ = M⁻¹ rhs, the own rows; in a cluster every CTA gets every entry
    if constexpr (kMinvReg) {
      const float xt = PROBE_SKIP(sp, kSkipMinvDots) ? 0.f : TM::dot(Mr, s_rhs, tid % KM);
      if (tid % KM == 0 && tid / KM < n) s_xt[tid / KM] = xt;
    } else {
      float4 rv[CH];
      load_chunks<CH>(rv, s_rhs, c, K, ch);
      for (int rb = 0; rb < nc; rb += G) {
        const int r = rb + g;
        const float xt = PROBE_SKIP(sp, kSkipMinvDots) ? 0.f :
            join(r < nc ? row_partial<CH>(sM + r * ld, rv, c, K, ch) : 0.f, K);
        if (r < nc) {
          if constexpr (kClustered) {
            cg::cluster_group cluster = cg::this_cluster();
            for (int cc = c; cc < sp.C; cc += K) cluster.map_shared_rank(s_xt, cc)[n0 + r] = xt;
          } else {
            if (c == 0) s_xt[n0 + r] = xt;
          }
        }
      }
    }
    if constexpr (kClustered) {
      if (PROBE_SKIP(sp, kSkipClusterSync)) __syncthreads();
      else cg::this_cluster().sync();
    } else {
      __syncthreads();
    }

    // (c) x ← αx̃ + (1−α)x; z̃ of the own rows, their projection and dual
    // update. A group takes K rows in turn and then thread c updates the
    // c-th of them, so that the update runs once for K rows.
    for (int j = tid; j < n; j += T) s_x[j] = alpha * s_xt[j] + beta * s_x[j];
    for (int k = tid; k < kc && !PROBE_SKIP(sp, kSkipRowUpdates); k += T)
      dt[k] = row_update(dd[k] * s_xt[k0 + k], dz[k], dy[k], dl[k], du[k], drho[k], dirho[k],
                         alpha, beta);
    float4 xv[CH];
    load_chunks<CH>(xv, s_xt, c, K, ch);
    for (int rb = 0; rb < mc; rb += G * K) {
      float mine = 0.f;
      for (int i = 0; i < K && rb + i * G < mc; ++i) {
        const int r = rb + i * G + g;
        const float zt = PROBE_SKIP(sp, kSkipRowDots) ? 0.f :
            join(r < mc ? row_partial<CH>(sA + r * ld, xv, c, K, ch) : 0.f, K);
        if (c == i) mine = zt;
      }
      const int r = rb + c * G + g;
      if (r < mc && !PROBE_SKIP(sp, kSkipRowUpdates))
        st[r] = row_update(mine, sz[r], sy[r], sl[r], su[r], srho[r], sirho[r], alpha, beta);
    }
    __syncthreads();
  }

  if (rank == 0)
    for (int j = tid; j < n; j += T) xo[b * n + j] = s_x[j];
  for (int r = tid; r < mc; r += T) {
    const int i = b * m + dense.at(r0 + r);
    zo[i] = sz[r];
    yo[i] = sy[r];
  }
  for (int k = tid; k < kc; k += T) {
    const int i = b * m + d0 + k0 + k;
    zo[i] = dz[k];
    yo[i] = dy[k];
  }
  // no CTA leaves while a neighbour may still reach into its shared memory
  if constexpr (kClustered) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// Global-memory variant, for a lane no cluster can hold: thread j owns
// element j of each stage, the vectors lie in shared memory in A's row
// order, and the matrices are read where they stand.

__global__ void __launch_bounds__(kMaxThreads)
admm_chunk_global(const float* __restrict__ Minv, const float* __restrict__ A,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ z0,
                  const float* __restrict__ y0, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo, Lane p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = p.n, m = p.m, d0 = p.d0, mg = p.mg, md = m - mg;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, sigma = p.sigma;
  const Rows dense{d0, mg};

  const float* Mp = Minv + static_cast<size_t>(b) * n * n;
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
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    // rhs = σx − q + Aᵀt   (thread j: column j of the dense rows, diagonal entry j)
    for (int j = tid; j < n; j += nt) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        // the dense rows before the diagonal segment, then those after it
        const int r1 = part == 0 ? d0 : m;
        int r = part == 0 ? 0 : d0 + mg;
        const float* Aj = Ab + j;
        for (; r + 3 < r1; r += 4) {
          a0 = fmaf(Aj[static_cast<size_t>(r + 0) * n], st[r + 0], a0);
          a1 = fmaf(Aj[static_cast<size_t>(r + 1) * n], st[r + 1], a1);
          a2 = fmaf(Aj[static_cast<size_t>(r + 2) * n], st[r + 2], a2);
          a3 = fmaf(Aj[static_cast<size_t>(r + 3) * n], st[r + 3], a3);
        }
        for (; r < r1; ++r) a0 = fmaf(Aj[static_cast<size_t>(r) * n], st[r], a0);
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

    // z̃ = A x̃, then the relaxation, projection and dual update of row i:
    // a thread a diagonal row, a warp a dense row
    for (int k = tid; k < mg; k += nt) {
      const int i = d0 + k;
      st[i] = row_update(sdg[k] * sxt[k], sz[i], sy[i], sl[i], su[i], srho[i],
                         sirho[i], alpha, beta);
    }
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
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt) xo[b * n + j] = sx[j];
  for (int i = tid; i < m; i += nt) {
    zo[b * m + i] = sz[i];
    yo[b * m + i] = sy[i];
  }
}

// ---------------------------------------------------------------------------
// Host side: which variant a shape takes, and its launch.

constexpr int kRowsThreads = 256;  // threads a CTA of the row-split kernel (T)
constexpr int kRowsK = 8;          // threads per row dot product there (K)
constexpr int kMaxCluster = 16;    // above 8 the cluster size is "non-portable"

size_t global_bytes(int n, int m, int mg) {
  return sizeof(float) * (4 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m) + mg);
}

// Per-device attributes, read once.
int g_smem_optin[kMaxDevices];
int g_sms[kMaxDevices];

int smem_budget(int dev) {
  if (g_smem_optin[dev] == 0)
    cudaDeviceGetAttribute(&g_smem_optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return g_smem_optin[dev];
}

int sm_count(int dev) {
  if (g_sms[dev] == 0) cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return g_sms[dev];
}

// The layout of a lane over C CTAs, K threads a row dot product. A row is
// padded to whole rounds of K float4 chunks; K ≥ 8 threads read 128
// contiguous bytes of a row at a time and meet every bank once at any such
// stride, and for K < 8 the stride also sets the 8/K rows of a quarter warp
// 16K bytes apart.
Split make_split(int n, int md, int mg, int C, int K) {
  Split sp;
  sp.C = C;
  sp.K = K;
  sp.minv_reg = C == 1 && n <= 64;
  int ld = (n + 4 * K - 1) / (4 * K) * (4 * K);
  while (K < 8 && ((ld % 32) % (4 * K) != 0 || ((ld % 32) / (4 * K)) % 2 == 0)) ld += 4 * K;
  sp.ld = ld;
  sp.lv = ld > 64 ? ld : 64;
  sp.nc = (n + C - 1) / C;
  sp.mc = (md + C - 1) / C;
  sp.kc = (mg + C - 1) / C;
  return sp;
}

size_t split_bytes(const Split& sp) { return sizeof(float) * static_cast<size_t>(sp.floats()); }

// threads per row dot product: 4 where M⁻¹ is held in registers (n ≤ 64), 8
// for longer rows, or more for a row beyond 8 rounds of chunks
int rows_K(int n) {
  int K = n <= 64 ? kRowsK / 2 : kRowsK;
  while (K < 32 && n > 32 * K) K <<= 1;
  return K;
}

// CTAs a lane for the row-split kernel: 1 when a block's shared memory holds
// the lane (the shared variant); else the smallest cluster that holds it,
// doubled up to 8 while a CTA still takes more than a third of an SM's shared
// memory (three resident CTAs hide each other's barriers), and doubled up to
// 16 while the launch would leave more than half of the SMs without a CTA;
// 0 when no cluster holds it.
int rows_cluster_size(int n, int m, int mg, int B, int device, int K) {
  const size_t budget = static_cast<size_t>(smem_budget(device));
  const int md = m - mg;
  if (n > 32 * K) return 0;  // a row beyond 8 rounds of chunks
  int C = 0;
  for (int c = 1; c <= kMaxCluster; c <<= 1)
    if (split_bytes(make_split(n, md, mg, c, K)) <= budget) { C = c; break; }
  if (C <= 1) return C;
  while (C < 8 && 3 * split_bytes(make_split(n, md, mg, C, K)) > budget) C <<= 1;
  while (C < kMaxCluster && 2 * B * C <= sm_count(device)) C <<= 1;
  return C;
}

int variant_for(int n, int m, int mg, int B, int device) {
  const int md = m - mg;
  if (n <= 0 || m <= 0 || B <= 0 || mg < 0 || mg > m || mg > n) return kUnsupported;
  if (device < 0 || device >= kMaxDevices) return kUnsupported;
  if (n <= 64 && md <= 64) return kRegister;
  const int C = rows_cluster_size(n, m, mg, B, device, rows_K(n));
  if (C == 1) return kShared;
  if (C > 1) return kCluster;
  if (global_bytes(n, m, mg) <= static_cast<size_t>(smem_budget(device))) return kGlobal;
  return kUnsupported;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                         const float*, const float*, const float*, const float*,
                         const float*, float*, float*, float*, Lane);
using RowsFn = void (*)(const float*, const float*, const float*, const float*,
                       const float*, const float*, const float*, const float*,
                       const float*, float*, float*, float*, Lane, Split);

// Kernel instances already given their attributes on a device: all of the
// opt-in dynamic shared memory and, for the cluster instance, the
// non-portable cluster sizes (above 8: the size changes with the lane count
// from call to call). A launch that the card then refuses comes back as its
// error.
struct Prepared { const void* fn; int dev; };
Prepared g_prepared[64];
int g_n_prepared = 0;

int prepare(const void* fn, int dev, bool clustered) {
  for (int i = 0; i < g_n_prepared; ++i)
    if (g_prepared[i].fn == fn && g_prepared[i].dev == dev) return 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_budget(dev));
  if (err == cudaSuccess && clustered)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_n_prepared < 64) g_prepared[g_n_prepared++] = Prepared{fn, dev};
  return 0;
}

// the register kernel instance for a shape: the tile's padded rows and
// whether it keeps dense rows; *threads gets its block size
template <int K>
KernelFn register_kernel(int n, int md, int* threads) {
  const bool small = n <= 32 && md <= 32;
  *threads = (small ? 32 : 64) * K;
  if (md > 0) return small ? &admm_chunk_reg<32, K, true> : &admm_chunk_reg<64, K, true>;
  return small ? &admm_chunk_reg<32, K, false> : &admm_chunk_reg<64, K, false>;
}

// The last cluster launch configuration found to fit the card.
struct ClusterFit { const void* fn; int dev, C; size_t bytes; };
ClusterFit g_fit;

// one launch of the row-split kernel with T threads a CTA, K threads a row
// and C CTAs a lane (C = 1: the shared variant)
template <int T>
int launch_rows(const float* Minv, const float* A, const float* q, const float* l,
                const float* u, const float* rho, const float* x, const float* z,
                const float* y, float* xo, float* zo, float* yo, int B, const Lane& p,
                int C, int K, int device, cudaStream_t s, int skip = 0) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) || K < 1 || K > 32 || (K & (K - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Split sp = make_split(p.n, p.m - p.mg, p.mg, C, K);
#ifdef ADMM_CHUNK_PROBE
  sp.skip = skip;
#else
  (void)skip;
#endif
  const size_t bytes = split_bytes(sp);
  if (bytes > static_cast<size_t>(smem_budget(device)) ||
      (p.n + 4 * K - 1) / (4 * K) > (sp.minv_reg ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) {
    const RowsFn fn = sp.minv_reg ? &admm_chunk_rows<T, true, false>
                                  : &admm_chunk_rows<T, false, false>;
    if (int err = prepare(reinterpret_cast<const void*>(fn), device, false)) return err;
    fn<<<B, T, bytes, s>>>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p, sp);
    return static_cast<int>(cudaGetLastError());
  }
  const RowsFn fn = &admm_chunk_rows<T, false, true>;
  if (int err = prepare(reinterpret_cast<const void*>(fn), device, true)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!(g_fit.fn == reinterpret_cast<const void*>(fn) && g_fit.dev == device && g_fit.C == C &&
        g_fit.bytes == bytes)) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    g_fit = ClusterFit{reinterpret_cast<const void*>(fn), device, C, bytes};
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, fn, Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p, sp));
}

// one chunk launch, the register variant tiled with K threads per row
template <int K>
int launch_chunk(const float* Minv, const float* A, const float* q, const float* l,
                 const float* u, const float* rho, const float* x, const float* z,
                 const float* y, float* xo, float* zo, float* yo,
                 int B, int n, int m, int d0, int mg, int iters, float sigma, float alpha,
                 int device, void* stream) {
  if (B <= 0 || d0 < 0 || d0 + mg > m) return static_cast<int>(cudaErrorInvalidValue);
  const int variant = variant_for(n, m, mg, B, device);
  if (variant == kUnsupported) return static_cast<int>(cudaErrorInvalidValue);
  const Lane p{n, m, d0, mg, iters, sigma, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kRegister) {
    int threads = 0;
    const KernelFn kernel = register_kernel<K>(n, m - mg, &threads);
    kernel<<<B, threads, 0, s>>>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == kShared || variant == kCluster) {
    const int C = rows_cluster_size(n, m, mg, B, device, rows_K(n));
    return launch_rows<kRowsThreads>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, C,
                                     rows_K(n), device, s);
  }
  int threads = ((n > m ? n : m) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (int err = prepare(reinterpret_cast<const void*>(&admm_chunk_global), device, false))
    return err;
  admm_chunk_global<<<B, threads, global_bytes(n, m, mg), s>>>(
      Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The variant a chunk of B lanes launches. 3: a lane's rows split over a
// thread-block cluster; 2: register variant; 1: matrices in one block's
// shared memory; 0: matrices read from global memory (no cluster holds the
// lane); -1: the vectors alone exceed a block's shared memory, or the
// declared diagonal rows outnumber the columns (not supported). The diagonal
// segment's row offset does not enter the choice.
int admm_chunk_variant(int n, int m, int mg, int B, int device) {
  return variant_for(n, m, mg, B, device);
}

// CTAs a lane of the shared (1) and cluster (2, 4, 8, 16) variants; 0 for a
// shape that takes another variant
int admm_chunk_cluster_size(int n, int m, int mg, int B, int device) {
  const int v = variant_for(n, m, mg, B, device);
  if (v != kShared && v != kCluster) return 0;
  return rows_cluster_size(n, m, mg, B, device, rows_K(n));
}

// Minv (B,n,n), A (B,m,n), q/x (B,n), l/u/rho/z/y (B,m); outputs xo (B,n),
// zo/yo (B,m). Rows d0 .. d0+mg of A are read as their diagonal alone.
// `device` is the current CUDA device. Returns the CUDA error of the launch:
// a cluster the card cannot place is cudaErrorLaunchOutOfResources.
int admm_chunk_f32(const float* Minv, const float* A, const float* q, const float* l,
                   const float* u, const float* rho, const float* x, const float* z,
                   const float* y, float* xo, float* zo, float* yo,
                   int B, int n, int m, int d0, int mg, int iters, float sigma, float alpha,
                   int device, void* stream) {
  return launch_chunk<kRowThreads>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, n, m,
                                   d0, mg, iters, sigma, alpha, device, stream);
}

}  // extern "C"
