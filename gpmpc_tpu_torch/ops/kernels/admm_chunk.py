"""The ADMM iteration chunk: hand-written Hopper kernel, its plain version,
and the wrapper that picks between them by device.

Counterpart of ``gpmpc_tpu/ops/pallas/admm_kernel.py`` (``admm_chunk`` and
``make_admm_chunk_lanes``): ``iters`` ADMM iterations per lane with the
lane's KKT inverse M⁻¹ and constraint matrix A held on chip for the whole
chunk. The CUDA source is ``gpmpc_tpu_torch/csrc/admm_chunk.cu``; its header
says what bounds it on the H100 and what the design does about that.

A's rows may carry the solver's declared structure (``row_structure``, the
``ADMMConfig`` field): ``("diag", nr)`` segments are applied through their
diagonal alone, ``("dense", nr)`` segments as dense rows, and rows past the
declared segments are dense. ``None`` means every row dense.

- :func:`admm_chunk` — the wrapper. A CUDA tensor launches the kernel (one
  launch per chunk) or raises; a CPU tensor runs :func:`admm_chunk_plain`.
  There is no fallback from the kernel to the plain version.
- :func:`admm_chunk_plain` — the same function in plain PyTorch (batched
  body of ``make_admm_chunk_lanes``'s unbatched path, with A applied as
  the JAX solver's streamed path applies a row structure). The CPU tests use
  it and the chip smoke test holds the kernel against it.
- :func:`variant` — which of the kernel's variants a shape launches.
- ``LAUNCHES`` — incremented once per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "admm_chunk"
LAUNCHES = 0
VARIANTS = {2: "register", 1: "shared", 0: "global"}

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


def compact_structure(A: torch.Tensor, segs: tuple) -> tuple:
    """Compact per-segment operands of the batched (scaled) A (B,m,n), in
    row order; rows past the declared segments form a trailing dense one.
    A "diag" segment of nr rows keeps A[r0+k, k], k < nr ≤ n."""
    m, n = A.shape[1], A.shape[2]
    ops = []
    r0 = 0
    for seg in segs:
        kind = seg[0]
        if kind == "dense":
            ops.append(("dense", A[:, r0 : r0 + seg[1]]))
            r0 += seg[1]
        elif kind == "diag":
            nr = seg[1]
            if nr > n:
                raise ValueError(f"a diag segment of {nr} rows exceeds A's {n} columns")
            ops.append(("diag", torch.diagonal(A[:, r0 : r0 + nr, :nr], dim1=1, dim2=2)))
            r0 += nr
        elif kind in ("blt", "blockdiag", "blockdiag_shared"):
            raise NotImplementedError(
                f"row-structure segment {kind!r} is not ported yet (it arrives "
                "with the 6-DoF slice); only 'dense' and 'diag'")
        else:
            raise ValueError(f"unknown row-structure segment {kind!r}")
    if r0 > m:
        raise ValueError("row structure exceeds A's rows")
    if r0 < m:
        ops.append(("dense", A[:, r0:]))
    return tuple(ops)


def make_A_ops(ops: tuple, n: int):
    """(A_apply, AT_apply) on batched vectors from compacted structure ops."""

    def A_apply(v):
        outs = []
        for kind, M in ops:
            if kind == "dense":
                outs.append(torch.bmm(M, v[:, :, None])[:, :, 0])
            else:  # diag
                outs.append(M * v[:, : M.shape[1]])
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def AT_apply(t):
        out = torch.zeros(t.shape[0], n, dtype=t.dtype, device=t.device)
        r0 = 0
        for kind, M in ops:
            nr = M.shape[1]
            ts = t[:, r0 : r0 + nr]
            if kind == "dense":
                out = out + torch.bmm(M.transpose(1, 2), ts[:, :, None])[:, :, 0]
            else:  # diag
                out = out + torch.nn.functional.pad(M * ts, (0, n - nr))
            r0 += nr
        return out

    return A_apply, AT_apply


def _segments(row_structure, m: int) -> tuple:
    return row_structure if row_structure is not None else (("dense", m),)


def admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters: int, sigma: float,
                     alpha: float, row_structure: Optional[tuple] = None) -> _Tensors:
    """Plain PyTorch chunk. Shapes: Minv (B,n,n), A (B,m,n), q/x (B,n),
    l/u/rho/z/y (B,m). Returns (x, z, y) after ``iters`` iterations."""
    n = A.shape[2]
    A_apply, AT_apply = make_A_ops(compact_structure(A, _segments(row_structure, A.shape[1])), n)
    inv_rho = 1.0 / rho
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * x - q + AT_apply(t)
        xt = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
        zt = A_apply(xt)
        xn = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y * inv_rho, l), u)
        y = y + rho * (zr - zn)
        x, z = xn, zn
    return x, z, y


def kernel_rows(A: torch.Tensor, row_structure) -> Tuple[torch.Tensor, int]:
    """A as the kernel reads it, and mg: the kernel applies the first mg
    rows (a leading "diag" segment) through their diagonal alone and every
    other row densely. A later "diag" segment is handed over as dense rows
    that hold its diagonal alone, which applies the same function."""
    ops = compact_structure(A, _segments(row_structure, A.shape[1]))
    mg = ops[0][1].shape[1] if ops[0][0] == "diag" else 0
    later, r0 = [], 0
    for i, (kind, M) in enumerate(ops):
        if kind == "diag" and i > 0:
            later.append((r0, M))
        r0 += M.shape[1]
    if later:
        A = A.clone()  # the diagonals in `later` still view the caller's A
        for r0, d in later:
            nr = d.shape[1]
            A[:, r0 : r0 + nr] = 0.0
            A[:, r0 : r0 + nr, :nr] = torch.diag_embed(d)
    return A, mg


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


def _launch(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha,
            row_structure) -> _Tensors:
    global LAUNCHES
    B, m, n = A.shape
    if not pallas_available(A.device):
        raise RuntimeError(
            f"the ADMM chunk kernel is built for sm_90a; {A.device} is "
            f"capability {torch.cuda.get_device_capability(A.device)}")
    A, mg = kernel_rows(A, row_structure)
    ins = [t.contiguous() for t in (Minv, A, q, l, u, rho, x, z, y)]
    xo = torch.empty_like(ins[6])
    zo = torch.empty_like(ins[7])
    yo = torch.empty_like(ins[8])
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.admm_chunk_f32(
            *[t.data_ptr() for t in ins], xo.data_ptr(), zo.data_ptr(),
            yo.data_ptr(), B, n, m, mg, int(iters), float(sigma), float(alpha),
            A.device.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"admm_chunk_f32 launch failed: CUDA error {err} "
                           f"(B={B}, n={n}, m={m}, diagonal rows {mg})")
    LAUNCHES += 1
    return xo, zo, yo


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.admm_chunk_f32.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        lib.admm_chunk_f32.argtypes = [p] * 12 + [i, i, i, i, i, f, f, i, p]
        lib.admm_chunk_f32.restype = i
        lib.admm_chunk_variant.argtypes = [i, i, i, i]
        lib.admm_chunk_variant.restype = i
    return lib


def variant(n: int, m: int, mg: int = 0, device=None) -> str:
    """The kernel variant a chunk with n columns, m rows and mg leading
    diagonal rows launches on ``device`` (default: the current CUDA device):
    "register" (matrices in registers), "shared" (in shared memory) or
    "global" (read from global memory). Raises for a shape none takes."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    v = _library().admm_chunk_variant(n, m, mg, index)
    if v not in VARIANTS:
        raise ValueError(f"no variant of the chunk kernel takes n={n}, m={m}, "
                         f"diagonal rows {mg}")
    return VARIANTS[v]


def admm_chunk(Minv, A, q, l, u, rho, x, z, y, iters: int, sigma: float,
               alpha: float, row_structure: Optional[tuple] = None) -> _Tensors:
    """Run ``iters`` ADMM iterations for every lane; returns (x, z, y).

    On CUDA tensors this launches the Hopper kernel once (or raises); on CPU
    tensors it runs :func:`admm_chunk_plain`."""
    _check(Minv, A, q, l, u, rho, x, z, y)
    if A.device.type == "cuda":
        return _launch(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha, row_structure)
    if A.device.type == "cpu":
        return admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha,
                                row_structure)
    raise ValueError(f"unsupported device {A.device}")
