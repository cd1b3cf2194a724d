// The ADMM chunk kernel with its tiling chosen per call, for the sweeps of
// gpmpc_tpu_torch/chunk_bench.py: the register tile's threads per row (K),
// and the row-split kernel's threads a CTA (T), threads per row dot product
// (K), CTAs a lane (C) and exchange of the partials (pushed or pulled). The
// port builds and launches admm_chunk.cu alone, with the tiling fixed there.

#include "admm_chunk.cu"

extern "C" {

// admm_chunk_f32 with K = row_threads, one of 1, 2 and 4
int admm_chunk_tile_f32(const float* Minv, const float* A, const float* q, const float* l,
                        const float* u, const float* rho, const float* x, const float* z,
                        const float* y, float* xo, float* zo, float* yo,
                        int B, int n, int m, int d0, int mg, int t0, int tb, int th, int tw,
                        int iters, float sigma, float alpha, int row_threads, int device,
                        void* stream) {
  const Lane p = make_lane(n, m, d0, mg, t0, tb, th, tw, iters, sigma, alpha);
  switch (row_threads) {
    case 1: return launch_chunk<1>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, device, stream);
    case 2: return launch_chunk<2>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, device, stream);
    case 4: return launch_chunk<4>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The row-split kernel with `threads` (128, 256 or 512) a CTA, `row_threads`
// a row dot product, `cluster` CTAs a lane (1: the shared variant; 0: as
// admm_chunk_f32 picks for B lanes) and the partials pushed (push = 1) or
// pulled (0).
int admm_chunk_rows_f32(const float* Minv, const float* A, const float* q, const float* l,
                        const float* u, const float* rho, const float* x, const float* z,
                        const float* y, float* xo, float* zo, float* yo,
                        int B, int n, int m, int d0, int mg, int t0, int tb, int th, int tw,
                        int iters, float sigma, float alpha, int threads, int row_threads,
                        int cluster, int push, int device, void* stream) {
  const Lane p = make_lane(n, m, d0, mg, t0, tb, th, tw, iters, sigma, alpha);
  if (!valid_rows(p, B) || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0)
    cluster = rows_tiling(kept_rows(p, row_threads), m, mg, B, device).C;
  switch (threads) {
    case 128:
      return launch_rows<128>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, push != 0, device, s);
    case 256:
      return launch_rows<256>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, push != 0, device, s);
    case 512:
      return launch_rows<512>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, push != 0, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
