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
// two segments: (d0, mg), the mg rows of A from row d0 on (a "diag"
// segment, mg ≤ n), read as their diagonal alone (row d0 + i has one entry,
// A[d0 + i][i]) and applied as elementwise products; and (t0, tb, th, tw),
// the tb·th rows from row t0 on (a "blt" segment: tb block rows of th rows,
// block row i nonzero in its first min((i+1)·tw, n) columns), of which the
// shared and cluster variants read the kept columns alone. Every other row
// is dense and read where it stands. On the main path (condensed 3-DoF QP,
// every state bound elided) all 60 rows are the identity control bounds, so
// A costs no matvec at all; the condensed QP with its state bounds is
// [state bounds (blt); control bounds (diag); facets (dense)], the sparse
// form (mpc/rti.py::_sparse_admm_cfg) [x₀'s identity and the dynamics rows
// (blt: N+1 block rows of n_x rows, n_x+n_u columns a block column, the
// last block clipped at n); variable bounds (diag); facets (dense)].
//
// Four variants serve the shapes; `admm_chunk_variant` picks by shape and
// lane count. Per lane and iteration the work is one dense matvec with M⁻¹
// (2n² flops), two with A's kept rows and O(n+m) elementwise work; every
// stage needs the whole previous vector, so an iteration is a chain of
// dependent reductions. The device-memory bound (each operand read once a
// chunk) and the f32 rate are far below every measured time: what costs is
// what an iteration re-reads, how long its chain is and, for many lanes,
// how many lanes the card holds at once. All times below are CUDA-graph
// replays on an NVIDIA H100 80GB HBM3, 700 W, from
// gpmpc_tpu_torch/chunk_bench.py and chip_smoke.py; PERF.md has the tables.
//
// 1. Register (n ≤ 64 and md ≤ 64: the main and RTI paths). Bound by the
//    latency of the chain: operands load in 3.6 µs, close to the bytes
//    bound, and then an iteration takes ~0.30 µs of barrier, broadcast
//    loads, split dot product, shuffle and row update.
//    - One CTA a lane, one launch a chunk. M⁻¹ (and the dense rows of A,
//      twice: row-major for A·x̃ and transposed for Aᵀt; a "blt" segment is
//      read whole here) are loaded once a chunk into registers: NP = 64
//      padded rows, K = 2 threads a row, 128 threads a lane, 32 entries of
//      each kept matrix a thread, indexed only with unrolled compile-time
//      indices (ptxas: 84 registers on the main path, 128 with dense rows).
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
// 2 and 3 are one template, admm_chunk_rows<T, kMinvReg, kClustered>: the
// lane's kept rows (every row but the diagonal ones, the "blt" segment's
// first, each cut to its kept columns) lie in shared memory for the whole
// chunk, copied in once by 4-byte cp.async (rows of n floats are not
// 16-byte aligned in general, n = 207; every thread has all of its copies
// in flight at once, where plain loads waited a few at a time: at the SCVX
// library's chunk the load takes 0.95 ms in the stage probe, 1.99 by plain
// loads).
// (a) each CTA forms its share of Aᵀt over its kept rows: a quarter warp
// reads 8 neighbouring float4 of one row (128 bytes, every bank once), the
// 4 quarters take 4 rows, and a set of 8 column chunks meets only the kept
// rows from the first that reaches it; the diagonal rows add their part;
// (b) x̃ = M⁻¹·rhs, K threads a row, each reading float4 chunks c, c+K, …;
// (c) z̃ of the kept rows (a row's dot product over its kept chunks alone),
// their projection and dual update, a group of K threads taking K rows in
// turn and thread c updating the c-th.
//
// 2. Shared (the lane fits one block's shared memory: the condensed QPs
//    with their state bounds, n ≤ 64, m = 150-380; the sparse 3-DoF QP at
//    N = 15 with its rows declared, n = 157, m = 269, 138 KB a lane).
//    - n ≤ 64: M⁻¹ in registers (256 threads, 4 a row), four lanes an SM.
//      The kept rows are stored at the stride of n, zero past their kept
//      columns (only the kept entries are read from device memory), and
//      walked and dotted whole with their places from their indices: at
//      rows of 16-80 floats a table of row places read in the loops cost
//      more than the entries it saved (the tile A/B against the kernel
//      before the "blt" segment, chunk_bench.py --sweep ab: with the table
//      the condensed shapes ran 11-38% slower than before, without it
//      4-16% faster). bounded (512, 60, 200, 25): 0.086 ms.
//    - n > 64: M⁻¹ in shared memory, 512 threads (at 256 and 128 lanes of
//      the N = 15 sparse QP 21% ahead of 256); rows compacted to their
//      kept columns, each at its own float4-aligned stride, found through
//      a table of (offset, chunks) a row; where the 8-chunk sets are fewer
//      than the warps, several warps share a set's rows and their sums are
//      added in slice order. suite_rti (256, 157, 269, 25): 0.24 ms,
//      against 0.42 with every row dense on the cluster variant.
//
// 3. Cluster (a lane beyond one block: the SCVX library's, n = 407,
//    m = 694, 906 KB a lane with its rows declared; the N = 20 sparse QP at
//    512 lanes, 237 KB): the lane split over the C CTAs of a thread-block
//    cluster, each with a contiguous slice of M⁻¹'s rows and a contiguous
//    run of kept rows; the runs are cut by shared memory, not row count
//    (block rows grow linearly, so an even split left the last CTA about
//    twice the first's entries).
//    - The partials of Aᵀt are pushed: each CTA stores its own into slot
//      `rank` of every CTA (distributed shared memory), and after one
//      cluster barrier each sums its C local slots in rank order, so that
//      every CTA holds the same rhs bit for bit; where the slots would cost
//      the lane its three CTAs an SM they are pulled instead, C remote
//      reads an entry. x̃'s rows are written into every CTA's copy, then a
//      second cluster barrier. Two barriers an iteration stay: (a) and (b)
//      each need every CTA's data, and the barrier is what waits for it.
//    - C and T (rows_tiling): few lanes spread a lane over up to 16 CTAs
//      (latency-bound: golden at 4 lanes 0.10 ms); many lanes take the
//      smallest cluster of at most 8 whose CTAs fit three to an SM at 256
//      threads (golden at 512 lanes: 4 CTAs, 0.98 ms against 1.58 with its
//      rows dense), else the smallest cluster that holds the lane at one
//      CTA of 512 threads an SM (the SCVX library: 8 CTAs, 8.3 ms against
//      16.9 with every row dense at 16).
//    - The stage probe at the SCVX library's chunk (chunk_bench.py --sweep
//      stages, its build): with every row dense at 16 CTAs a lane, 21.0 ms
//      = load 2.2, arithmetic 7.9 (row dots 3.8, M⁻¹ 2.2, column walk 1.7),
//      remote sum 3.5, cluster barriers 3.9, the rest loop and block
//      barriers; with the rows declared at 8 CTAs, 8.4 ms = load 0.95,
//      arithmetic 3.4 (column walk 1.6, M⁻¹ 0.87, row dots 0.64), the
//      pushed exchange ~0, cluster barriers 1.2, the rest 2.7.
//    - A cluster the card cannot place (cudaOccupancyMaxActiveClusters
//      answers 0) is refused with cudaErrorLaunchOutOfResources.
//
// 4. Global (a lane no cluster of 16 holds). The vectors lie in shared
//    memory and the matrices are read from global memory every iteration,
//    one CTA a lane; bound by L2 and device-memory latency and bandwidth.
//    It is the first design of this port, kept for such lanes alone.
//
// Tensor cores and TMA are still not the tool. Each lane's matrix meets one
// vector per iteration: a chain of GEMVs with no reuse to feed an MMA tile,
// and the port keeps f32 with TF32 off. The one load of the matrices a chunk
// has no compute to hide behind (cp.async only keeps it in flight), and rows
// of n floats are not the 16-byte aligned tiles a TMA copy takes.
//
// C interface for ctypes: admm_chunk_f32(...) returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kUnsupported = -1, kGlobal = 0, kShared = 1, kRegister = 2, kCluster = 3 };

struct Lane {
  int n, m;
  int d0, mg;          // the "diag" segment: rows d0 … d0+mg, row d0+i one entry, A[d0+i][i]
  int t0, tb, th, tw;  // the "blt" segment: rows t0 … t0+tb·th (tb = 0: none)
  int iters;
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
// Every matrix entry the kernel keeps lies in shared memory (M⁻¹ in
// registers where n ≤ 64) for the whole chunk.

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
  kSkipColumnWalk = 1,   // (a) the reads of A for Aᵀt
  kSkipMinvDots = 2,     // (b) the dot products with M⁻¹
  kSkipRowDots = 4,      // (c) the dot products with A's rows
  kSkipRowUpdates = 8,   // (c) projection and dual update, kept and diagonal rows
  kSkipRemoteSum = 16,   // cluster: the partials of Aᵀt sent to (or read from) the peers
  kSkipClusterSync = 32, // cluster: block barriers in place of cluster barriers
  kSkipBroadcast = 64,   // cluster: x̃ written into the peers' copies
  kSkipAsyncCopy = 128   // the matrices loaded by plain loads, not cp.async
};

constexpr int kMaxCluster = 16;  // above 8 the cluster size is "non-portable"

// Row stride in shared memory of a kept row of L columns, K threads a dot
// product. For K ≥ 8 whole float4 chunks: a quarter warp reads 128
// contiguous bytes of one row, which meets every bank once at any 16-byte
// aligned stride. For K < 8 whole rounds of K chunks, the stride setting the
// 8/K rows of a quarter warp 16K bytes apart.
// (K is a power of two, so the rounding is by masks: a kernel computes the
// strides of its rows at every load.)
__host__ __device__ inline int row_ld(int L, int K) {
  if (K >= 8) return (L + 3) & ~3;
  const int q = 4 * K;  // 4, 8 or 16: divides 32
  const int ld = (L + q - 1) & -q;
  return (ld & 31 & q) ? ld : ld + q;  // (ld mod 32) / q odd
}

// The rows of A the row-split kernel keeps, in its order: every row but the
// "diag" segment's. First the "blt" segment's tb·th rows (block row i keeps
// its first min((i+1)·tw, n) columns: the rest are its declared zero
// blocks), then the other rows in row order, each whole. A CTA holds a
// contiguous range of this order: runs of rows of one stride, the block rows
// of the segment it reaches, then the other rows.
struct Kept {
  int n, d0, mg, t0, tb, th, tw, K;
  // one CTA a lane with M⁻¹ in registers (n ≤ 64: the condensed QPs): every
  // kept row at the stride of n, zero past its kept columns, so that a row's
  // place follows from its index (at rows of 16-80 floats a place read from
  // a table cost more than the entries it saved: the tile A/B at the
  // condensed QPs, chunk_bench.py --sweep ab)
  bool uniform;

  __host__ __device__ int blt_rows() const { return tb * th; }
  // the row of A of kept row r
  __host__ __device__ int row(int r) const {
    const int nt = blt_rows();
    if (r < nt) return t0 + r;
    r -= nt;
    const bool diag_first = d0 < t0;
    const int a0 = diag_first ? d0 : t0, al = diag_first ? mg : nt;
    const int b0 = diag_first ? t0 : d0, bl = diag_first ? nt : mg;
    if (r >= a0) r += al;
    if (r >= b0) r += bl;
    return r;
  }
  // the kept columns of block row i, and of kept row r
  __host__ __device__ int block_cols(int i) const {
    const int c = (i + 1) * tw;
    return c < n ? c : n;
  }
  __host__ __device__ int cols(int r) const { return r < blt_rows() ? block_cols(r / th) : n; }
  __host__ __device__ int ld(int r) const { return row_ld(uniform ? n : cols(r), K); }
  // floats of the kept rows before kept row r, each at its stride
  __host__ __device__ int off(int r) const {
    if (uniform) return r * row_ld(n, K);
    int o = 0, rest = r;
    if (tb > 0) {
      const int nt = blt_rows(), rr = r < nt ? r : nt, full = rr / th;
      for (int i = 0; i < full; ++i) o += th * row_ld(block_cols(i), K);
      if (rr < nt) o += (rr - full * th) * row_ld(block_cols(full), K);
      rest = r - rr;
    }
    return o + rest * row_ld(n, K);
  }
  // the first kept row with a column in float4 chunk jj (columns 4jj … 4jj+3):
  // the kept rows that reach a column are a suffix of the order, since kept
  // lengths never fall along it
  __host__ __device__ int first_with_chunk(int jj) const {
    if (tb == 0) return 0;
    const int i = 4 * jj / tw;  // block rows i … keep (i+1)·tw > 4jj columns
    return (i < tb ? i : tb) * th;
  }
};

// warps that share a set of 8 column chunks in the column walk of rows at
// their own strides: the sets are dealt out to NW warps, several warps a set
// where they are fewer (rows at one stride are walked a warp a set)
__host__ __device__ inline int walk_slices(int sets, int NW) {
  return sets >= NW ? 1 : NW / sets;
}

struct Split {
  int C;       // CTAs a lane: 1 for the shared variant
  int K;       // threads that share a row's dot product
  int ldm;     // row stride of M⁻¹ in shared memory, floats
  int lv;      // length of the zero-padded vectors: a multiple of 4K, ≥ 64
  int q4;      // float4 chunks of a row of n
  int nc, kc;  // rows of M⁻¹ and diagonal rows a CTA owns at most
  int mc, ac;  // kept rows and their floats a CTA owns at most
  int minv_reg;  // M⁻¹ in registers (one CTA a lane, n ≤ 64)
  int push;      // cluster: partials pushed into the peers (else pulled from them)
  int rb[kMaxCluster + 1];  // CTA c owns kept rows rb[c] … rb[c+1]
#ifdef ADMM_CHUNK_PROBE
  int skip;        // stages the probe build leaves out (Stage bits)
#endif

  // the partials' buffer: C slots where they are pushed, one where pulled
  __host__ __device__ int part_floats() const { return C == 1 ? 0 : (push ? C : 1) * lv; }
  // the column walk's slice sums at T threads a CTA (none where it takes no slices)
  __host__ __device__ int walk_floats(int T) const {
    const int ws = minv_reg ? 1 : walk_slices((q4 + 7) / 8, T / 32);
    return ws > 1 ? ws * lv : 0;
  }
  __host__ __device__ int floats(int T) const {
    return (minv_reg ? 0 : nc * ldm + 2 * mc) + ac + 4 * lv + part_floats() + walk_floats(T) +
           7 * mc + 8 * kc;
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

// this thread's share of Σ_k row[k]·v[k]: chunks c, c+K, … of a row of nch
// float4 chunks
template <int CH>
__device__ __forceinline__ float row_partial(const float4* row, const float4 (&v)[CH], int c,
                                             int K, int nch) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (c + K * i < nch) {
      const float4 w = row[c + K * i];
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
// thread); without it three CTAs of 256 threads an SM (85 a thread), or one
// of 512 (128 a thread).
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
  constexpr int NW = T / 32;
  using TM = Tile<64, KM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m, d0 = p.d0, mg = p.mg;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, sigma = p.sigma;
  const int ldm = sp.ldm, lv = sp.lv, K = sp.K;
  const Kept kept{n, d0, mg, p.t0, p.tb, p.th, p.tw, K, kMinvReg};

  int rank = 0;
  if constexpr (kClustered) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / sp.C;
  // this CTA's rows of M⁻¹, kept rows of A and diagonal rows
  const int n0 = min(rank * sp.nc, n), nc = min(sp.nc, n - n0);
  // (rb read at constant indices: indexed by the rank, the whole Split
  // would be copied to local memory and every read of it would go there)
  int r0 = 0, r1 = sp.rb[1];
  if constexpr (kClustered) {
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c == rank) { r0 = sp.rb[c]; r1 = sp.rb[c + 1]; }
  }
  const int mc = r1 - r0;
  const int k0 = min(rank * sp.kc, mg), kc = min(sp.kc, mg - k0);
  const int a0 = kClustered ? kept.off(r0) : 0;

  const float* Mg = Minv + static_cast<size_t>(b) * n * n;
  const float* Ab = A + static_cast<size_t>(b) * m * n;

  float* sM = smem;                                // own rows of M⁻¹ (nc × ldm)
  float* sA = sM + (kMinvReg ? 0 : sp.nc * ldm);   // own kept rows, each at its stride (ac)
  float* s_rhs = sA + sp.ac;                       // rhs, whole (lv)
  float* s_xt = s_rhs + lv;                        // x̃, whole (lv)
  float* s_x = s_xt + lv;                          // x, whole (lv)
  float* s_q = s_x + lv;                           // q, whole (lv)
  float* s_part = s_q + lv;                        // partials of Aᵀt, cluster only
  float* s_walk = s_part + sp.part_floats();       // the walk's slices' sums (ws × lv)
  // own kept row r: float4 offset in sA and float4 chunks
  int2* rinfo = reinterpret_cast<int2*>(s_walk + sp.walk_floats(T));
  float* sz = reinterpret_cast<float*>(rinfo + (kMinvReg ? 0 : sp.mc));  // own kept rows: z y l u ρ 1/ρ t
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

  // ---- one load per chunk, by runs of rows of one stride: M⁻¹'s rows,
  // then each block row of the "blt" segment and the other kept rows. A row
  // of 64 floats or more is a warp's, its lanes along the row; shorter rows
  // are copied flat over the run (the stage probe: at the condensed QP's
  // rows of 16-80 floats the flat copy loads in 0.018 ms where a warp a row
  // took 0.030; at the SCVX library's rows a warp a row loads in 0.71 ms,
  // flat 1.14). Rows of n floats are not 16-byte aligned in general
  // (n = 207), so the copy is 4-byte asynchronous copies (cp.async) into the
  // padded layout: every thread has all of its copies in flight at once,
  // where plain loads waited for device memory a few at a time.
  auto copy = [&](float* dst, const float* src) {
    if (PROBE_SKIP(sp, kSkipAsyncCopy)) *dst = *src;
    else __pipeline_memcpy_async(dst, src, sizeof(float));
  };
  float Mr[kMinvReg ? TM::C : 1];
  if constexpr (kMinvReg) {
    TM::template load<false>(Mr, Mg, n, n, n, tid / KM, tid % KM, Rows{0, 0});
  } else {
    for (int r = warp; r < nc; r += NW) {
      const float* src = Mg + static_cast<size_t>(n0 + r) * n;
      float* dst = sM + r * ldm;
      for (int j = lane; j < ldm; j += 32) {
        if (j < n) copy(dst + j, src + j);
        else dst[j] = 0.f;
      }
    }
  }
  // the warps and threads take up each run where the last one left them
  const int nt = kept.blt_rows();
  for (int r = 0; r < mc;) {  // a run: a block row of the segment, or the other rows
    const int kr = r0 + r;
    const int re = kr < nt ? min(mc, (kr / p.th + 1) * p.th - r0) : mc;
    const int L = kept.cols(kr), ld = kept.ld(kr), o = kept.off(kr) - a0, rows = re - r;
    if (ld >= 64) {
      for (int i = ((warp - r) % NW + NW) % NW; i < rows; i += NW) {
        const float* src = Ab + static_cast<size_t>(kept.row(kr + i)) * n;
        float* dst = sA + o + i * ld;
        for (int j = lane; j < ld; j += 32) {
          if (j < L) copy(dst + j, src + j);
          else dst[j] = 0.f;
        }
      }
    } else {
      for (int k = ((tid - o) % T + T) % T; k < rows * ld; k += T) {
        const int i = k / ld, j = k - i * ld;
        if (j < L) copy(sA + o + k, Ab + static_cast<size_t>(kept.row(kr + i)) * n + j);
        else sA[o + k] = 0.f;
      }
    }
    if constexpr (!kMinvReg)  // rows at one stride need no table
      for (int i = tid; i < rows; i += T) rinfo[r + i] = make_int2(o / 4 + i * (ld / 4), ld / 4);
    r = re;
  }
  __pipeline_commit();
  for (int k = tid; k < lv; k += T) {
    s_rhs[k] = 0.f;
    s_xt[k] = 0.f;
    s_x[k] = k < n ? x0[b * n + k] : 0.f;
    s_q[k] = k < n ? q[b * n + k] : 0.f;
  }
  for (int r = tid; r < mc; r += T) {
    const int i = b * m + kept.row(r0 + r);
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
  __pipeline_wait_prior(0);
  __syncthreads();
  // every CTA of the cluster runs before any reaches into a peer
  if constexpr (kClustered) cg::this_cluster().sync();

  const float4* sA4 = reinterpret_cast<const float4*>(sA);
  const float4* sM4 = reinterpret_cast<const float4*>(sM);
  // Aᵀt: a quarter warp reads 8 neighbouring float4 of one row (128 bytes,
  // every bank once); the 4 quarters of a warp take rows r, r+1, r+2, r+3
  const int part = lane >> 3, q4 = (n + 3) / 4, sets = (q4 + 7) / 8, lv4 = lv / 4;
  const int ws = kMinvReg ? 1 : walk_slices(sets, NW);
  const int ldu4 = row_ld(n, K) / 4;  // the float4 stride of rows at one stride
  // row dot products: group g of K threads, thread c its chunks c, c+K, …
  const int G = T / K, g = tid / K, c = tid - g * K, ch = (n + 4 * K - 1) / (4 * K);

  for (int it = 0; it < p.iters; ++it) {
    // (a) this CTA's share of Aᵀt over its kept rows and diagonal rows: the
    // 8 column chunks of a set meet only the kept rows from the first that
    // reaches the set's first chunk on; a warp walks them together (one
    // start for the warp: the quarters read one row at a time), and a lane
    // reads a row only where it reaches the lane's chunk. Where the sets are
    // fewer than the warps (short rows), ws warps share a set's rows, each
    // writing its slice's sums, which are then added in slice order.
    // finish: chunk jj's sum plus the diagonal rows, into the rhs (one CTA) or
    // into slot `rank` of the CTAs c0, c0 + dc, … (a cluster)
    auto finish = [&](int jj, float4 acc, int c0, int dc) {
      float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * jj + e - k0;
        if (k >= 0 && k < kc) a[e] = fmaf(dd[k], dt[k], a[e]);
      }
      const float4 v = make_float4(a[0], a[1], a[2], a[3]);
      if constexpr (kClustered) {
        if (sp.push) {
          cg::cluster_group cluster = cg::this_cluster();
          float4* slot = reinterpret_cast<float4*>(s_part) + rank * lv4 + jj;
          for (int cc = c0; cc < sp.C; cc += dc)
            if (cc == rank || !PROBE_SKIP(sp, kSkipRemoteSum)) *cluster.map_shared_rank(slot, cc) = v;
        } else if (c0 == 0) {
          reinterpret_cast<float4*>(s_part)[jj] = v;
        }
      } else if (c0 == 0) {
        const float4 xv = reinterpret_cast<const float4*>(s_x)[jj];
        const float4 qv = reinterpret_cast<const float4*>(s_q)[jj];
        reinterpret_cast<float4*>(s_rhs)[jj] =
            make_float4(sigma * xv.x - qv.x + a[0], sigma * xv.y - qv.y + a[1],
                        sigma * xv.z - qv.z + a[2], sigma * xv.w - qv.w + a[3]);
      }
    };
    for (int job = warp; job < sets * ws; job += NW) {
      int set = job, slice = 0;
      if (ws > 1) { slice = job / sets; set = job - slice * sets; }
      const int jj = set * 8 + (lane & 7);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kMinvReg) {
        // rows at one stride, zero past their kept columns: walked whole,
        // no row's place read from a table (where a lane's chunk lies past a
        // row's kept columns it reads zeros)
        if (jj < q4 && !PROBE_SKIP(sp, kSkipColumnWalk)) {
          const float4* col = sA4 + jj;
#pragma unroll 4
          for (int r = part; r < mc; r += 4) {
            const float4 w = col[r * ldu4];
            const float t = st[r];
            acc.x = fmaf(w.x, t, acc.x);
            acc.y = fmaf(w.y, t, acc.y);
            acc.z = fmaf(w.z, t, acc.z);
            acc.w = fmaf(w.w, t, acc.w);
          }
        }
      } else if (!PROBE_SKIP(sp, kSkipColumnWalk)) {
        const int rs = max(kept.first_with_chunk(set * 8) - r0, 0);
#pragma unroll 4
        for (int r = rs + part + 4 * slice; r < mc; r += 4 * ws) {
          const int2 ri = rinfo[r];
          if (jj < ri.y) {
            const float4 w = sA4[ri.x + jj];
            const float t = st[r];
            acc.x = fmaf(w.x, t, acc.x);
            acc.y = fmaf(w.y, t, acc.y);
            acc.z = fmaf(w.z, t, acc.z);
            acc.w = fmaf(w.w, t, acc.w);
          }
        }
      }
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        acc.x += __shfl_xor_sync(kFull, acc.x, off);
        acc.y += __shfl_xor_sync(kFull, acc.y, off);
        acc.z += __shfl_xor_sync(kFull, acc.z, off);
        acc.w += __shfl_xor_sync(kFull, acc.w, off);
      }
      if (jj < q4) {  // every quarter holds the sum
        if (ws == 1) finish(jj, acc, part, 4);  // the quarters take turns at the peers
        else if (part == 0) reinterpret_cast<float4*>(s_walk)[slice * lv4 + jj] = acc;
      }
    }
    if (ws > 1) {
      __syncthreads();
      const float4* w4 = reinterpret_cast<const float4*>(s_walk);
      for (int j = tid; j < q4; j += T) {
        float4 acc = w4[j];
        for (int sl = 1; sl < ws; ++sl) {
          const float4 v = w4[sl * lv4 + j];
          acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
        }
        finish(j, acc, 0, 1);
      }
    }
    if constexpr (kClustered) {
      // rhs = σx − q + the C partials, summed in rank order in every CTA, so
      // that every CTA holds the same rhs bit for bit
      cg::cluster_group cluster = cg::this_cluster();
      if (PROBE_SKIP(sp, kSkipClusterSync)) __syncthreads();
      else cluster.sync();
      // a thread an entry: n threads each read C partials (unrolled, so
      // that the loads are in flight together; the sum stays in rank order)
      for (int j = tid; j < n; j += T) {
        float s = 0.f;
        if (sp.push) {
#pragma unroll 4
          for (int cc = 0; cc < sp.C; ++cc) s += s_part[cc * lv + j];
        } else {
#pragma unroll 4
          for (int cc = 0; cc < sp.C; ++cc)
            s += PROBE_SKIP(sp, kSkipRemoteSum) ? s_part[j]
                                                : cluster.map_shared_rank(s_part, cc)[j];
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
            join(r < nc ? row_partial<CH>(sM4 + r * (ldm / 4), rv, c, K, ldm / 4) : 0.f, K);
        if (r < nc) {
          if constexpr (kClustered) {
            cg::cluster_group cluster = cg::this_cluster();
            for (int cc = c; cc < sp.C; cc += K)
              if (cc == rank || !PROBE_SKIP(sp, kSkipBroadcast))
                cluster.map_shared_rank(s_xt, cc)[n0 + r] = xt;
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
        float zt = 0.f;
        if (r < mc && !PROBE_SKIP(sp, kSkipRowDots)) {
          if constexpr (kMinvReg) {  // its place from its index, whole
            zt = row_partial<CH>(sA4 + r * ldu4, xv, c, K, ldu4);
          } else {
            const int2 ri = rinfo[r];
            zt = row_partial<CH>(sA4 + ri.x, xv, c, K, ri.y);
          }
        }
        zt = join(zt, K);
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
    const int i = b * m + kept.row(r0 + r);
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

constexpr int kRowsK = 8;  // threads per row dot product of the row-split kernel (K)

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

int g_smem_sm[kMaxDevices];

int smem_per_sm(int dev) {
  if (g_smem_sm[dev] == 0)
    cudaDeviceGetAttribute(&g_smem_sm[dev], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return g_smem_sm[dev];
}

int sm_count(int dev) {
  if (g_sms[dev] == 0) cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return g_sms[dev];
}

// The layout of a lane over C CTAs, K threads a row dot product. M⁻¹'s rows
// and the diagonal rows are dealt out evenly; the kept rows go out in
// contiguous runs of even shared memory (row stride plus its eight words of
// row state), which for a "blt" segment gives the CTAs of its short first
// block rows more rows than those of its long last ones.
Split make_split(Kept kp, int md, int mg, int C, int K, bool push) {
  Split sp{};
  const int n = kp.n;
  kp.uniform = C == 1 && n <= 64;  // as the kernel instance with M⁻¹ in registers lays it out
  sp.C = C;
  sp.K = K;
  sp.minv_reg = C == 1 && n <= 64;
  sp.push = C > 1 && push;
  sp.ldm = row_ld(n, K);
  const int lv = (n + 4 * K - 1) / (4 * K) * (4 * K);
  sp.lv = lv > 64 ? lv : 64;
  sp.q4 = (n + 3) / 4;
  sp.nc = (n + C - 1) / C;
  sp.kc = (mg + C - 1) / C;
  const long long total = kp.off(md) + 8LL * md;
  long long cum = 0;
  int r = 0;
  sp.rb[0] = 0;
  for (int cc = 1; cc < C; ++cc) {
    const long long target = total * cc / C;
    // a row goes to the earlier CTA while its middle lies before the cut
    while (r < md && 2 * cum + kp.ld(r) + 8 <= 2 * target) { cum += kp.ld(r) + 8; ++r; }
    sp.rb[cc] = r;
  }
  for (int cc = C; cc <= kMaxCluster; ++cc) sp.rb[cc] = md;
  for (int cc = 0; cc < C; ++cc) {
    const int rows = sp.rb[cc + 1] - sp.rb[cc];
    const int floats = kp.off(sp.rb[cc + 1]) - kp.off(sp.rb[cc]);
    if (rows > sp.mc) sp.mc = rows;
    if (floats > sp.ac) sp.ac = floats;
  }
  return sp;
}

// shared memory of a CTA of T threads (the picker asks at 512, the most)
size_t split_bytes(const Split& sp, int T = 512) {
  return sizeof(float) * static_cast<size_t>(sp.floats(T));
}

// threads per row dot product: 4 where M⁻¹ is held in registers (n ≤ 64), 8
// for longer rows, or more for a row beyond 8 rounds of chunks
int rows_K(int n) {
  int K = n <= 64 ? kRowsK / 2 : kRowsK;
  while (K < 32 && n > 32 * K) K <<= 1;
  return K;
}

// The tiling of the row-split kernel: C CTAs a lane, T threads a CTA, the
// partials of Aᵀt pushed into the peers (C slots a CTA) or pulled from them.
struct Tiling { int C, T, push; };

// CTAs of `bytes` of shared memory that one SM holds at once (1 KB a block
// is the system's)
int ctas_per_sm(size_t bytes, int device) {
  return static_cast<int>(static_cast<size_t>(smem_per_sm(device)) / (bytes + 1024));
}

// Picked from the tile sweep (chunk_bench.py --sweep cluster, H100):
// 1. a lane one block holds takes one CTA (the shared variant), 512 threads
//    (256 with M⁻¹ in registers, n ≤ 64): at 256 and 128 lanes of the sparse
//    3-DoF QP at N = 15 512 threads beat 256 by 21% and clusters of 2-16;
// 2. few lanes (a launch that would leave half of the SMs idle) spread a
//    lane over the most CTAs that keep it so, up to 16: latency-bound;
// 3. many lanes take the smallest cluster of at most 8 whose CTAs fit three
//    to an SM, the most the register file holds at 256 threads (pushing the
//    partials where the slots still fit, else pulling them): at 512 lanes of
//    the N = 20 QP 4 CTAs of 256 take 0.92 ms, 2 of 512 1.10 and 8 of 256
//    1.51. Where that would take 16 (non-portable clusters, which the card
//    places a few to a GPC, and 16 partials to exchange), the smallest
//    cluster that holds the lane runs one CTA of 512 threads an SM: at the
//    SCVX library's 704 lanes 8 CTAs of 512 pushing take 7.28 ms, 16 of 256
//    pulling 7.74, 16 of 256 pushing 9.28;
// 0 CTAs where no cluster of 16 holds a lane.
Tiling rows_tiling_uncached(const Kept& kp, int m, int mg, int B, int device) {
  const size_t budget = static_cast<size_t>(smem_budget(device));
  const int md = m - mg, K = kp.K;
  auto bytes = [&](int C, bool push) { return split_bytes(make_split(kp, md, mg, C, K, push)); };
  if (kp.n > 32 * K) return Tiling{0, 0, 0};  // a row beyond 8 rounds of chunks
  if (bytes(1, false) <= budget) return Tiling{1, kp.n <= 64 ? 256 : 512, 0};
  int C = 2;
  while (C <= kMaxCluster && bytes(C, false) > budget) C <<= 1;
  if (C > kMaxCluster) return Tiling{0, 0, 0};
  if (2 * B * C <= sm_count(device)) {
    while (C < kMaxCluster && 2 * B * C <= sm_count(device)) C <<= 1;
    return Tiling{C, 256, bytes(C, true) <= budget};
  }
  for (int c = C; c <= 8; c <<= 1) {
    if (ctas_per_sm(bytes(c, true), device) >= 3) return Tiling{c, 256, 1};
    if (ctas_per_sm(bytes(c, false), device) >= 3) return Tiling{c, 256, 0};
  }
  if (C <= 8) return Tiling{C, 512, bytes(C, true) <= budget};
  const bool push = ctas_per_sm(bytes(C, true), device) >= 2;
  return Tiling{C, push || ctas_per_sm(bytes(C, false), device) >= 2 ? 256 : 512, push};
}

// The tilings already picked (make_split walks every kept row): a launch
// asks for its shape's again.
struct Pick { int n, m, mg, tb, th, tw, K, B, dev; Tiling t; };
Pick g_picks[16];
int g_n_picks = 0;

Tiling rows_tiling(const Kept& kp, int m, int mg, int B, int device) {
  for (int i = 0; i < g_n_picks && i < 16; ++i) {
    const Pick& e = g_picks[i];
    if (e.n == kp.n && e.m == m && e.mg == mg && e.tb == kp.tb && e.th == kp.th &&
        e.tw == kp.tw && e.K == kp.K && e.B == B && e.dev == device)
      return e.t;
  }
  const Tiling t = rows_tiling_uncached(kp, m, mg, B, device);
  g_picks[g_n_picks++ % 16] = Pick{kp.n, m, mg, kp.tb, kp.th, kp.tw, kp.K, B, device, t};
  return t;
}

Kept kept_rows(const Lane& p, int K) {
  return Kept{p.n, p.d0, p.mg, p.t0, p.tb, p.th, p.tw, K, false};
}

// the segments fit A and each other
bool valid_rows(const Lane& p, int B) {
  if (p.n <= 0 || p.m <= 0 || B <= 0 || p.mg < 0 || p.mg > p.m || p.mg > p.n) return false;
  if (p.d0 < 0 || p.d0 + p.mg > p.m || p.tb < 0) return false;
  if (p.tb == 0) return true;
  const int nt = p.tb * p.th;
  if (p.th <= 0 || p.tw <= 0 || p.t0 < 0 || p.t0 + nt > p.m) return false;
  return p.mg == 0 || p.t0 + nt <= p.d0 || p.d0 + p.mg <= p.t0;
}

int variant_for(const Lane& p, int B, int device) {
  const int md = p.m - p.mg;
  if (!valid_rows(p, B)) return kUnsupported;
  if (device < 0 || device >= kMaxDevices) return kUnsupported;
  if (p.n <= 64 && md <= 64) return kRegister;
  const int C = rows_tiling(kept_rows(p, rows_K(p.n)), p.m, p.mg, B, device).C;
  if (C == 1) return kShared;
  if (C > 1) return kCluster;
  if (global_bytes(p.n, p.m, p.mg) <= static_cast<size_t>(smem_budget(device))) return kGlobal;
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

// The last cluster launch configurations found to fit the card.
struct ClusterFit { const void* fn; int dev, C; size_t bytes; };
ClusterFit g_fit[8];
int g_n_fit = 0;

// one launch of the row-split kernel with T threads a CTA, K threads a row
// and C CTAs a lane (C = 1: the shared variant)
template <int T>
int launch_rows(const float* Minv, const float* A, const float* q, const float* l,
                const float* u, const float* rho, const float* x, const float* z,
                const float* y, float* xo, float* zo, float* yo, int B, const Lane& p,
                int C, int K, bool push, int device, cudaStream_t s, int skip = 0) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) || K < 1 || K > 32 || (K & (K - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Split sp = make_split(kept_rows(p, K), p.m - p.mg, p.mg, C, K, push);
#ifdef ADMM_CHUNK_PROBE
  sp.skip = skip;
#else
  (void)skip;
#endif
  const size_t bytes = split_bytes(sp, T);
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
  bool known = false;
  for (int i = 0; i < g_n_fit && !known; ++i)
    known = g_fit[i].fn == reinterpret_cast<const void*>(fn) && g_fit[i].dev == device &&
            g_fit[i].C == C && g_fit[i].bytes == bytes;
  if (!known) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    g_fit[g_n_fit % 8] = ClusterFit{reinterpret_cast<const void*>(fn), device, C, bytes};
    ++g_n_fit;
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, fn, Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p, sp));
}

// the row-split launch with the port's tiling (rows_tiling)
int launch_rows_auto(const float* Minv, const float* A, const float* q, const float* l,
                     const float* u, const float* rho, const float* x, const float* z,
                     const float* y, float* xo, float* zo, float* yo, int B, const Lane& p,
                     int device, cudaStream_t s, int skip = 0) {
  const int K = rows_K(p.n);
  const Tiling t = rows_tiling(kept_rows(p, K), p.m, p.mg, B, device);
  if (t.T == 512)
    return launch_rows<512>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, t.C, K, t.push,
                            device, s, skip);
  return launch_rows<256>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, t.C, K, t.push,
                          device, s, skip);
}

// one chunk launch, the register variant tiled with K threads per row
template <int K>
int launch_chunk(const float* Minv, const float* A, const float* q, const float* l,
                 const float* u, const float* rho, const float* x, const float* z,
                 const float* y, float* xo, float* zo, float* yo, int B, const Lane& p,
                 int device, void* stream) {
  const int variant = variant_for(p, B, device);
  if (variant == kUnsupported) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kRegister) {
    int threads = 0;
    const KernelFn kernel = register_kernel<K>(p.n, p.m - p.mg, &threads);
    kernel<<<B, threads, 0, s>>>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == kShared || variant == kCluster)
    return launch_rows_auto(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, device, s);
  int threads = ((p.n > p.m ? p.n : p.m) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (int err = prepare(reinterpret_cast<const void*>(&admm_chunk_global), device, false))
    return err;
  admm_chunk_global<<<B, threads, global_bytes(p.n, p.m, p.mg), s>>>(
      Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, p);
  return static_cast<int>(cudaGetLastError());
}

Lane make_lane(int n, int m, int d0, int mg, int t0, int tb, int th, int tw, int iters,
               float sigma, float alpha) {
  if (tb <= 0) t0 = tb = th = tw = 0;
  return Lane{n, m, d0, mg, t0, tb, th, tw, iters, sigma, alpha};
}

}  // namespace

extern "C" {

// The variant a chunk of B lanes launches. 3: a lane's rows split over a
// thread-block cluster; 2: register variant; 1: matrices in one block's
// shared memory; 0: matrices read from global memory (no cluster holds the
// lane); -1: the vectors alone exceed a block's shared memory, or the
// declared segments do not fit A (not supported). The segments' row offsets
// do not enter the choice.
int admm_chunk_variant(int n, int m, int mg, int tb, int th, int tw, int B, int device) {
  const int t0 = mg > 0 ? mg : 0;  // any offset clear of the diagonal rows
  return variant_for(make_lane(n, m, 0, mg, t0, tb, th, tw, 0, 0.f, 0.f), B, device);
}

// CTAs a lane of the shared (1) and cluster (2, 4, 8, 16) variants; 0 for a
// shape that takes another variant
int admm_chunk_cluster_size(int n, int m, int mg, int tb, int th, int tw, int B, int device) {
  const Lane p = make_lane(n, m, 0, mg, mg > 0 ? mg : 0, tb, th, tw, 0, 0.f, 0.f);
  const int v = variant_for(p, B, device);
  if (v != kShared && v != kCluster) return 0;
  return rows_tiling(kept_rows(p, rows_K(n)), m, mg, B, device).C;
}

// threads a CTA of the launch: the register tile's, the row-split kernel's
// (256 or 512) or the global variant's; 0 for a shape no variant takes
int admm_chunk_threads(int n, int m, int mg, int tb, int th, int tw, int B, int device) {
  const Lane p = make_lane(n, m, 0, mg, mg > 0 ? mg : 0, tb, th, tw, 0, 0.f, 0.f);
  const int v = variant_for(p, B, device);
  if (v == kRegister) {
    int threads = 0;
    register_kernel<kRowThreads>(n, m - mg, &threads);
    return threads;
  }
  if (v == kShared || v == kCluster) {
    return rows_tiling(kept_rows(p, rows_K(n)), m, mg, B, device).T;
  }
  if (v == kGlobal) {
    const int threads = ((n > m ? n : m) + 31) / 32 * 32;
    return threads > kMaxThreads ? kMaxThreads : threads;
  }
  return 0;
}

// Minv (B,n,n), A (B,m,n), q/x (B,n), l/u/rho/z/y (B,m); outputs xo (B,n),
// zo/yo (B,m). Rows d0 .. d0+mg of A are read as their diagonal alone; rows
// t0 .. t0+tb·th form a "blt" segment (tb = 0: none) whose block row i is
// read as its first min((i+1)·tw, n) columns; every other row whole.
// `device` is the current CUDA device. Returns the CUDA error of the launch:
// a cluster the card cannot place is cudaErrorLaunchOutOfResources.
int admm_chunk_f32(const float* Minv, const float* A, const float* q, const float* l,
                   const float* u, const float* rho, const float* x, const float* z,
                   const float* y, float* xo, float* zo, float* yo,
                   int B, int n, int m, int d0, int mg, int t0, int tb, int th, int tw,
                   int iters, float sigma, float alpha, int device, void* stream) {
  return launch_chunk<kRowThreads>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B,
                                   make_lane(n, m, d0, mg, t0, tb, th, tw, iters, sigma, alpha),
                                   device, stream);
}

}  // extern "C"
