// The ADMM chunk kernel with its register tile's threads per row (K) chosen
// per call, for the tile sweep of gpmpc_tpu_torch/chunk_bench.py. The port
// builds and launches admm_chunk.cu alone, with K fixed there.

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

}  // extern "C"
