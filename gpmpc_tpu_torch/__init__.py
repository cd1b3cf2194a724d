"""PyTorch + CUDA port of the GP-MPC rocket-landing engine, for one NVIDIA H100.

Counterpart of the JAX package ``gpmpc_tpu`` with the same module tree and
names. Everything here is batch-first: functions take the leading lane axis
B explicitly where the JAX code relied on ``jax.vmap``, and ``lax.scan``
loops are Python loops. The one hot loop that the JAX package wrote as a
Pallas kernel — the ADMM iteration chunk — is a hand-written CUDA kernel
(``csrc/admm_chunk.cu``, wrapped by ``ops/kernels/admm_chunk.py``).

Numerics are float32 end to end. TF32 is switched off for matmuls and
convolutions, as the JAX package pins f32 matmul precision: reduced-precision
products break the condensed-QP numerics.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
