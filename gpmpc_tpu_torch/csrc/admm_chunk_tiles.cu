// The ADMM chunk kernel with its tiling chosen per call, for the sweeps of
// gpmpc_tpu_torch/chunk_bench.py: the register tile's threads per row (K),
// and the row-split kernel's threads a CTA (T), threads per row dot product
// (K) and CTAs a lane (C). The port builds and launches admm_chunk.cu alone,
// with the tiling fixed there.

#include "admm_chunk.cu"

extern "C" {

// admm_chunk_f32 with K = row_threads, one of 1, 2 and 4
int admm_chunk_tile_f32(const float* Minv, const float* A, const float* q, const float* l,
                        const float* u, const float* rho, const float* x, const float* z,
                        const float* y, float* xo, float* zo, float* yo,
                        int B, int n, int m, int d0, int mg, int iters, float sigma,
                        float alpha, int row_threads, int device, void* stream) {
  switch (row_threads) {
    case 1:
      return launch_chunk<1>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, n, m, d0, mg,
                             iters, sigma, alpha, device, stream);
    case 2:
      return launch_chunk<2>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, n, m, d0, mg,
                             iters, sigma, alpha, device, stream);
    case 4:
      return launch_chunk<4>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, n, m, d0, mg,
                             iters, sigma, alpha, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The row-split kernel with `threads` (128, 256 or 512) a CTA, `row_threads`
// a row dot product and `cluster` CTAs a lane (1: the shared variant; 0: as
// admm_chunk_f32 picks for B lanes).
int admm_chunk_rows_f32(const float* Minv, const float* A, const float* q, const float* l,
                        const float* u, const float* rho, const float* x, const float* z,
                        const float* y, float* xo, float* zo, float* yo,
                        int B, int n, int m, int d0, int mg, int iters, float sigma,
                        float alpha, int threads, int row_threads, int cluster, int device,
                        void* stream) {
  if (B <= 0 || n <= 0 || d0 < 0 || mg < 0 || mg > n || d0 + mg > m ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const Lane p{n, m, d0, mg, iters, sigma, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) cluster = rows_cluster_size(n, m, mg, B, device, row_threads);
  switch (threads) {
    case 128:
      return launch_rows<128>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, device, s);
    case 256:
      return launch_rows<256>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, device, s);
    case 512:
      return launch_rows<512>(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, cluster,
                              row_threads, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
