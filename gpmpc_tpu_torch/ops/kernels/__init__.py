"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (counterpart of ``gpmpc_tpu/ops/pallas``)."""

# published H100 SXM peaks, which the kernels' bounds are taken against:
# device memory bandwidth and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
