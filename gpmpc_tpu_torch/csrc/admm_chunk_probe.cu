// The row-split kernel of admm_chunk.cu built with its stage probe, for
// gpmpc_tpu_torch/chunk_bench.py --sweep stages: a chunk with the stages in
// `skip` (Stage bits of admm_chunk.cu) left out is timed, never used. The
// port builds and launches admm_chunk.cu alone, where the probe folds away.

#define ADMM_CHUNK_PROBE
#include "admm_chunk.cu"

extern "C" {

// admm_chunk_f32 for a shape of the shared or cluster variant, with the
// port's tiling for B lanes, without the stages named in `skip`
int admm_chunk_probe_f32(const float* Minv, const float* A, const float* q, const float* l,
                         const float* u, const float* rho, const float* x, const float* z,
                         const float* y, float* xo, float* zo, float* yo,
                         int B, int n, int m, int d0, int mg, int t0, int tb, int th, int tw,
                         int iters, float sigma, float alpha, int skip, int device,
                         void* stream) {
  const Lane p = make_lane(n, m, d0, mg, t0, tb, th, tw, iters, sigma, alpha);
  const int variant = variant_for(p, B, device);
  if (variant != kShared && variant != kCluster) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows_auto(Minv, A, q, l, u, rho, x, z, y, xo, zo, yo, B, p, device,
                          static_cast<cudaStream_t>(stream), skip);
}

}  // extern "C"
