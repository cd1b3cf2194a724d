"""The ADMM iteration chunk: hand-written Hopper kernel, its plain version,
and the wrapper that picks between them by device.

Counterpart of ``gpmpc_tpu/ops/pallas/admm_kernel.py`` (``admm_chunk`` and
``make_admm_chunk_lanes``): ``iters`` ADMM iterations per lane with the
lane's KKT inverse M⁻¹ and constraint matrix A held on chip for the whole
chunk. The CUDA source is ``gpmpc_tpu_torch/csrc/admm_chunk.cu``; its header
says what bounds it on the H100 and what the design does about that.

- :func:`admm_chunk` — the wrapper. A CUDA tensor launches the kernel (one
  launch per chunk) or raises; a CPU tensor runs :func:`admm_chunk_plain`.
  There is no fallback from the kernel to the plain version.
- :func:`admm_chunk_plain` — the same function in plain PyTorch (batched
  body of ``make_admm_chunk_lanes``'s unbatched path). The CPU tests use it
  and the chip smoke test holds the kernel against it.
- ``LAUNCHES`` — incremented once per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

KERNEL = "admm_chunk"
LAUNCHES = 0

_Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pallas_available(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) can run the
    hand-written kernel: a CUDA device of compute capability 9.x (Hopper).
    Keeps the JAX package's name for the same question."""
    if not torch.cuda.is_available():
        return False
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return False
    return torch.cuda.get_device_capability(dev)[0] == 9


def admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters: int,
                     sigma: float, alpha: float) -> _Tensors:
    """Plain PyTorch chunk. Shapes: Minv (B,n,n), A (B,m,n), q/x (B,n),
    l/u/rho/z/y (B,m). Returns (x, z, y) after ``iters`` iterations."""
    inv_rho = 1.0 / rho
    AT = A.transpose(1, 2)
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * x - q + torch.bmm(AT, t[:, :, None])[:, :, 0]
        xt = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
        zt = torch.bmm(A, xt[:, :, None])[:, :, 0]
        xn = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y * inv_rho, l), u)
        y = y + rho * (zr - zn)
        x, z = xn, zn
    return x, z, y


def _check(Minv, A, q, l, u, rho, x, z, y) -> Tuple[int, int, int]:
    if A.dim() != 3:
        raise ValueError(f"A must be (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    want = {
        "Minv": (Minv, (B, n, n)), "q": (q, (B, n)), "x": (x, (B, n)),
        "l": (l, (B, m)), "u": (u, (B, m)), "rho": (rho, (B, m)),
        "z": (z, (B, m)), "y": (y, (B, m)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("A", A)] + [(k, v[0]) for k, v in want.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    return B, m, n


def _launch(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha) -> _Tensors:
    global LAUNCHES
    B, m, n = A.shape
    if not pallas_available(A.device):
        raise RuntimeError(
            f"the ADMM chunk kernel is built for sm_90a; {A.device} is "
            f"capability {torch.cuda.get_device_capability(A.device)}")
    ins = [t.contiguous() for t in (Minv, A, q, l, u, rho, x, z, y)]
    xo = torch.empty_like(ins[6])
    zo = torch.empty_like(ins[7])
    yo = torch.empty_like(ins[8])
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.admm_chunk_f32(
            *[t.data_ptr() for t in ins], xo.data_ptr(), zo.data_ptr(),
            yo.data_ptr(), B, n, m, int(iters), float(sigma), float(alpha),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"admm_chunk_f32 launch failed: CUDA error {err} "
                           f"(B={B}, n={n}, m={m})")
    LAUNCHES += 1
    return xo, zo, yo


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.admm_chunk_f32.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        lib.admm_chunk_f32.argtypes = [p] * 12 + [i, i, i, i, f, f, p]
        lib.admm_chunk_f32.restype = i
        lib.admm_chunk_smem_variant.argtypes = [i, i]
        lib.admm_chunk_smem_variant.restype = i
    return lib


def smem_variant(n: int, m: int) -> int:
    """Which variant a (n, m) chunk launches on the current card: 1 keeps
    the matrices in shared memory, 0 reads them from global memory."""
    return _library().admm_chunk_smem_variant(n, m)


def admm_chunk(Minv, A, q, l, u, rho, x, z, y, iters: int, sigma: float,
               alpha: float) -> _Tensors:
    """Run ``iters`` ADMM iterations for every lane; returns (x, z, y).

    On CUDA tensors this launches the Hopper kernel once (or raises); on CPU
    tensors it runs :func:`admm_chunk_plain`."""
    _check(Minv, A, q, l, u, rho, x, z, y)
    if A.device.type == "cuda":
        return _launch(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha)
    if A.device.type == "cpu":
        return admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters,
                                sigma, alpha)
    raise ValueError(f"unsupported device {A.device}")
