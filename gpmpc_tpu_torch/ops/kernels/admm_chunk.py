"""The ADMM iteration chunk: hand-written Hopper kernel, its plain version,
and the wrapper that picks between them by device.

Counterpart of ``gpmpc_tpu/ops/pallas/admm_kernel.py`` (``admm_chunk`` and
``make_admm_chunk_lanes``): ``iters`` ADMM iterations per lane with the
lane's KKT inverse M⁻¹ and constraint matrix A held on chip for the whole
chunk. The CUDA source is ``gpmpc_tpu_torch/csrc/admm_chunk.cu``.

One launch runs one of four variants, picked by shape and lane count
(:func:`variant`); the source's header has the measurements behind each
(NVIDIA H100 80GB HBM3, 700 W):

- "register" (n ≤ 64 and at most 64 dense rows: the main and RTI paths):
  M⁻¹ and the dense rows in registers, one CTA a lane; bound by the latency
  chain of an iteration (~0.30 µs), which one barrier and split dot
  products keep short.
- "shared" (a lane that fits one block's shared memory: the condensed QP
  with its state bounds, n = 60, m = 200; the 6-DoF QP with cone facets,
  m = 380; the sparse 3-DoF QP at N = 15 with its rows declared, n = 157,
  m = 269): M⁻¹ in registers where n ≤ 64, A's kept entries once in shared
  memory for both directions, every dot product split over several threads;
  bound by shared-memory bandwidth.
- "cluster" (a larger lane: the SCVX library's, n = 407, m = 694; the
  golden sparse QP at 512 lanes): the lane's rows split over a thread-block
  cluster of 2 to 16 CTAs (:func:`cluster_size`), every kept matrix entry in
  shared memory for the whole chunk, the partials of Aᵀt pushed into the
  peers and x̃ exchanged through distributed shared memory; bound by barrier
  latency for few lanes and by the waves of lanes for many.
- "global" (a lane no cluster holds): matrices read from global memory
  every iteration; bound by L2 and device-memory traffic.

A's rows may carry the solver's declared structure (``row_structure``, the
``ADMMConfig`` field), a tuple of segments in row order: ``("dense", nr)``,
``("diag", nr)``, ``("blt", C, h, w)``, ``("blockdiag", nb, h, w)`` and
``("blockdiag_shared", nb, h, w)``; rows past the declared segments are
dense and ``None`` means every row dense. The plain version and the solver's
streamed loop apply each segment through its structural nonzeros alone
(:func:`compact_structure`, :func:`make_A_ops`; a "blt" segment of 8 block
rows or more as one product of its zero-padded blocks). The kernel applies the
first ``"diag"`` segment through its diagonal and, in the shared and cluster
variants, reads the first ``"blt"`` segment as its blocks' kept columns
alone (block row i its first min((i+1)·w, n); :func:`kernel_blt`), wherever
each stands among the rows; every other row it reads whole, as both TPU
kernels read A. The port's sparse-form solves declare their rows so
(``mpc/rti.py::_sparse_admm_cfg``).

- :func:`admm_chunk` — the wrapper. A CUDA tensor launches the kernel (one
  launch per chunk) or raises, also when the card refuses the launch (a
  cluster it cannot place, shared memory beyond the opt-in); a CPU tensor
  runs :func:`admm_chunk_plain`. There is no fallback from the kernel to the
  plain version.
- :func:`admm_chunk_plain` — the same function in plain PyTorch (batched
  body of ``make_admm_chunk_lanes``'s unbatched path, with A applied as
  the JAX solver's streamed path applies a row structure). The CPU tests use
  it and the chip smoke test holds the kernel against it.
- :func:`make_admm_chunk_lanes` — the JAX factory's counterpart: the same
  wrapper with ``iters``, ``sigma`` and ``alpha`` bound (one kernel serves
  both TPU kernels, lanes first).
- :func:`variant`, :func:`cluster_size`, :func:`threads` — which variant a
  shape and lane count launch, over how many CTAs a lane, with how many
  threads a CTA.
- ``LAUNCHES`` — incremented once per kernel launch, and nowhere else;
  ``LAUNCHES_BY_SHAPE`` counts the same launches by (n, m),
  ``LAUNCHES_BY_ROWS`` by (n, m, mg, (C, h, w)): the diagonal rows and the
  "blt" segment each read as declared.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "admm_chunk"
BLT_PRODUCT_BLOCKS = 8  # block rows from which make_A_ops applies a "blt" segment as one product
LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}
LAUNCHES_BY_ROWS: dict = {}
VARIANTS = {3: "cluster", 2: "register", 1: "shared", 0: "global"}

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


def _seg_rows(seg: tuple) -> int:
    """Rows of one declared segment."""
    kind = seg[0]
    if kind in ("dense", "diag"):
        return seg[1]
    if kind in ("blt", "blockdiag", "blockdiag_shared"):
        return seg[1] * seg[2]
    raise ValueError(f"unknown row-structure segment {kind!r}")


def compact_structure(A: torch.Tensor, segs: tuple, E: Optional[torch.Tensor] = None,
                      D: Optional[torch.Tensor] = None) -> tuple:
    """Compact per-segment operands of the batched (scaled) A (B,m,n), in
    row order; rows past the declared segments form a trailing dense one.
    Every operand is a view of A.

    - "dense": the rows. "diag" (nr ≤ n rows): A[r0+k, k].
    - "blt" (C blocks of h rows, w columns a block column): block row i keeps
      its first (i+1)·w columns.
    - "blockdiag" (nb·w = n): the (B,nb,h,w) diagonal blocks.
    - "blockdiag_shared": one unscaled (h,w) block repeated every stage. The
      scaled stage-k block is diag(E_k)·B·diag(D_k), so the operand is the
      scaled stage-0 block and the per-stage ratio vectors r_k = E_k/E_0,
      c_k = D_k/D_0 from the Ruiz scalings ``E`` (B,m) and ``D`` (B,n); without
      them (unscaled A) the ratios are 1."""
    Bsz, m, n = A.shape
    ops = []
    r0 = 0
    for seg in segs:
        kind, nr = seg[0], _seg_rows(seg)
        rows = A[:, r0 : r0 + nr]
        if kind == "dense":
            ops.append(("dense", rows))
        elif kind == "diag":
            if nr > n:
                raise ValueError(f"a diag segment of {nr} rows exceeds A's {n} columns")
            ops.append(("diag", torch.diagonal(rows[:, :, :nr], dim1=1, dim2=2)))
        elif kind == "blt":
            _, C, h, w = seg
            ops.append(("blt", tuple(rows[:, i * h : (i + 1) * h, : (i + 1) * w]
                                     for i in range(C))))
        else:
            _, nb, h, w = seg
            if nb * w != n:
                raise ValueError(f"{kind} segment must tile all columns")
            if r0 + nr > m:
                raise ValueError("row structure exceeds A's rows")
            blocks = rows.reshape(Bsz, nb, h, nb, w)
            if kind == "blockdiag":
                ops.append(("blockdiag",
                            torch.diagonal(blocks, dim1=1, dim2=3).permute(0, 3, 1, 2)))
            elif E is not None and D is not None:
                E_seg = E[:, r0 : r0 + nr].reshape(Bsz, nb, h)
                D_seg = D.reshape(Bsz, nb, w)
                ops.append(("blockdiag_shared", blocks[:, 0, :, 0],
                            E_seg / E_seg[:, :1], D_seg / D_seg[:, :1]))
            else:
                ops.append(("blockdiag_shared", blocks[:, 0, :, 0],
                            A.new_ones(Bsz, nb, h), A.new_ones(Bsz, nb, w)))
        r0 += nr
    if r0 > m:
        raise ValueError("row structure exceeds A's rows")
    if r0 < m:
        ops.append(("dense", A[:, r0:]))
    return tuple(ops)


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def make_A_ops(ops: tuple, n: int, cast=None):
    """(A_apply, AT_apply) on batched vectors from compacted structure ops.
    ``cast``, if given, is applied to the vector each matrix operand
    multiplies ("diag" segments excepted): the solver's bf16 stream rounds
    it as it rounds the operands. A "blt" segment of fewer than
    ``BLT_PRODUCT_BLOCKS`` block rows is applied block row by block row, as
    the JAX solver applies it; a longer one as one product of its blocks
    zero-padded to n columns, built here once: there N+1 products a call
    (the sparse form's block rows) cost more than the zeros they skip."""
    pad = torch.nn.functional.pad
    cv = cast or (lambda t: t)
    ops = tuple((op[0], torch.cat([pad(b, (0, n - b.shape[2])) for b in op[1]], dim=1))
                if op[0] == "blt" and len(op[1]) >= BLT_PRODUCT_BLOCKS else op for op in ops)

    def A_apply(v):
        Bsz = v.shape[0]
        outs = []
        for op in ops:
            kind, M = op[0], op[1]
            if kind == "dense":
                outs.append(_bmv(M, cv(v)))
            elif kind == "diag":
                outs.append(M * v[:, : M.shape[1]])
            elif kind == "blt" and torch.is_tensor(M):
                outs.append(_bmv(M, cv(v)))
            elif kind == "blt":
                outs.extend(_bmv(blk, cv(v[:, : blk.shape[2]])) for blk in M)
            elif kind == "blockdiag":
                nb, w = M.shape[1], M.shape[3]
                outs.append(torch.einsum("bkij,bkj->bki", M, cv(v.reshape(Bsz, nb, w)))
                            .reshape(Bsz, -1))
            else:  # blockdiag_shared: r_k · (B0 (c_k · v_k))
                _, B0, r, c = op
                cV = cv(c * v.reshape(c.shape))
                outs.append((r * torch.einsum("bij,bkj->bki", B0, cV)).reshape(Bsz, -1))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def AT_apply(t):
        Bsz = t.shape[0]
        out = torch.zeros(Bsz, n, dtype=t.dtype, device=t.device)
        r0 = 0
        for op in ops:
            kind, M = op[0], op[1]
            if kind == "dense":
                nr = M.shape[1]
                out = out + _bmv(M.transpose(1, 2), cv(t[:, r0 : r0 + nr]))
            elif kind == "diag":
                nr = M.shape[1]
                out = out + pad(M * t[:, r0 : r0 + nr], (0, n - nr))
            elif kind == "blt" and torch.is_tensor(M):
                nr = M.shape[1]
                out = out + _bmv(M.transpose(1, 2), cv(t[:, r0 : r0 + nr]))
            elif kind == "blt":
                nr = 0
                for blk in M:
                    h, cols = blk.shape[1], blk.shape[2]
                    ts = cv(t[:, r0 + nr : r0 + nr + h])
                    out = out + pad(_bmv(blk.transpose(1, 2), ts), (0, n - cols))
                    nr += h
            elif kind == "blockdiag":
                nb, h = M.shape[1], M.shape[2]
                nr = nb * h
                ts = cv(t[:, r0 : r0 + nr].reshape(Bsz, nb, h))
                out = out + torch.einsum("bkij,bki->bkj", M, ts).reshape(Bsz, -1)
            else:  # blockdiag_shared: c_k · (B0ᵀ (r_k · t_k))
                _, B0, r, c = op
                nr = r.shape[1] * r.shape[2]
                rT = cv(r * t[:, r0 : r0 + nr].reshape(r.shape))
                out = out + (c * torch.einsum("bij,bki->bkj", B0, rT)).reshape(Bsz, -1)
            r0 += nr
        return out

    return A_apply, AT_apply


def _segments(row_structure, m: int) -> tuple:
    return row_structure if row_structure is not None else (("dense", m),)


def admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters: int, sigma: float,
                     alpha: float, row_structure: Optional[tuple] = None,
                     E: Optional[torch.Tensor] = None,
                     D: Optional[torch.Tensor] = None) -> _Tensors:
    """Plain PyTorch chunk. Shapes: Minv (B,n,n), A (B,m,n), q/x (B,n),
    l/u/rho/z/y (B,m). Returns (x, z, y) after ``iters`` iterations. ``E``
    and ``D`` are the Ruiz scalings a "blockdiag_shared" segment needs."""
    n = A.shape[2]
    A_apply, AT_apply = make_A_ops(
        compact_structure(A, _segments(row_structure, A.shape[1]), E=E, D=D), n)
    inv_rho = 1.0 / rho
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * x - q + AT_apply(t)
        xt = _bmv(Minv, rhs)
        zt = A_apply(xt)
        xn = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y * inv_rho, l), u)
        y = y + rho * (zr - zn)
        x, z = xn, zn
    return x, z, y


def kernel_rows(A: torch.Tensor, row_structure) -> Tuple[torch.Tensor, int, int]:
    """A as the kernel reads it, with (d0, mg): the kernel applies the mg
    rows from row d0 on (the first "diag" segment, wherever it stands)
    through their diagonal alone and every other row where it lies (the
    first "blt" segment through its kept entries, :func:`kernel_blt`): no
    copy of A is made for it. A further "diag" segment is handed over as
    dense rows that hold its diagonal alone, which applies the same function
    and costs a copy of A."""
    m, n = A.shape[1], A.shape[2]
    d0 = mg = r0 = 0
    later = []
    for seg in _segments(row_structure, m):
        nr = _seg_rows(seg)
        if seg[0] == "diag":
            if nr > n:
                raise ValueError(f"a diag segment of {nr} rows exceeds A's {n} columns")
            if mg == 0:
                d0, mg = r0, nr
            else:
                later.append((r0, nr))
        elif seg[0] in ("blockdiag", "blockdiag_shared") and seg[1] * seg[3] != n:
            raise ValueError(f"{seg[0]} segment must tile all columns")
        r0 += nr
    if r0 > m:
        raise ValueError("row structure exceeds A's rows")
    if later:
        A = A.clone()
        for r0, nr in later:
            d = torch.diagonal(A[:, r0 : r0 + nr, :nr], dim1=1, dim2=2).clone()
            A[:, r0 : r0 + nr] = 0.0
            A[:, r0 : r0 + nr, :nr] = torch.diag_embed(d)
    return A, d0, mg


def kernel_blt(row_structure, m: int) -> Tuple[int, int, int, int]:
    """The "blt" segment the kernel reads through its kept entries alone:
    (t0, C, h, w) of the first one declared, rows t0 … t0 + C·h, block row i
    kept as its first min((i+1)·w, n) columns (the rest are its declared
    zero blocks); (0, 0, 0, 0) where none is. Further "blt" segments, and
    the rows of the other kinds but the first "diag", are read whole."""
    r0 = 0
    for seg in _segments(row_structure, m):
        if seg[0] == "blt" and seg[1] * seg[2] > 0:
            return (r0, seg[1], seg[2], seg[3])
        r0 += _seg_rows(seg)
    return (0, 0, 0, 0)


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
            row_structure, out) -> _Tensors:
    global LAUNCHES
    B, m, n = A.shape
    if not pallas_available(A.device):
        raise RuntimeError(
            f"the ADMM chunk kernel is built for sm_90a; {A.device} is "
            f"capability {torch.cuda.get_device_capability(A.device)}")
    A, d0, mg = kernel_rows(A, row_structure)
    blt = kernel_blt(row_structure, m)
    ins = [t.contiguous() for t in (Minv, A, q, l, u, rho, x, z, y)]
    xo, zo, yo = out if out is not None else (torch.empty_like(t) for t in ins[6:])
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.admm_chunk_f32(
            *[t.data_ptr() for t in ins], xo.data_ptr(), zo.data_ptr(),
            yo.data_ptr(), B, n, m, d0, mg, *blt, int(iters), float(sigma), float(alpha),
            A.device.index, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"admm_chunk_f32 launch failed: CUDA error {err} (B={B}, n={n}, m={m}, "
            f"diagonal rows {d0}..{d0 + mg}, blt segment {blt}, "
            f"variant {variant(n, m, mg, B, A.device, blt[1:])}, "
            f"{cluster_size(n, m, mg, B, A.device, blt[1:])} CTAs a lane)")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(n, m)] = LAUNCHES_BY_SHAPE.get((n, m), 0) + 1
    rows = (n, m, mg, blt[1:])
    LAUNCHES_BY_ROWS[rows] = LAUNCHES_BY_ROWS.get(rows, 0) + 1
    return xo, zo, yo


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.admm_chunk_f32.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        lib.admm_chunk_f32.argtypes = [p] * 12 + [i] * 10 + [f, f, i, p]
        lib.admm_chunk_f32.restype = i
        lib.admm_chunk_variant.argtypes = [i] * 8
        lib.admm_chunk_variant.restype = i
        lib.admm_chunk_cluster_size.argtypes = [i] * 8
        lib.admm_chunk_cluster_size.restype = i
        lib.admm_chunk_threads.argtypes = [i] * 8
        lib.admm_chunk_threads.restype = i
    return lib


def _device_index(device) -> int:
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def variant(n: int, m: int, mg: int = 0, lanes: int = 1, device=None,
            blt: tuple = (0, 0, 0)) -> str:
    """The kernel variant a chunk of ``lanes`` lanes with n columns, m rows,
    mg diagonal rows and a "blt" segment of ``blt`` = (C, h, w) (anywhere
    among the rows; (0, 0, 0): none) launches on ``device`` (default: the
    current CUDA device): "register" (matrices in registers), "shared" (in
    one block's shared memory), "cluster" (a lane's rows split over the
    shared memory of a thread-block cluster) or "global" (read from global
    memory: a lane no cluster holds). Raises for a shape none takes."""
    v = _library().admm_chunk_variant(n, m, mg, *blt, lanes, _device_index(device))
    if v not in VARIANTS:
        raise ValueError(f"no variant of the chunk kernel takes n={n}, m={m}, "
                         f"diagonal rows {mg}, blt segment {blt}")
    return VARIANTS[v]


def cluster_size(n: int, m: int, mg: int = 0, lanes: int = 1, device=None,
                 blt: tuple = (0, 0, 0)) -> int:
    """CTAs a lane of the launch :func:`variant` names: 1 for the shared
    variant, the cluster size (2 to 16, by shape and lane count) for the
    cluster variant, 0 for the others."""
    return _library().admm_chunk_cluster_size(n, m, mg, *blt, lanes, _device_index(device))


def threads(n: int, m: int, mg: int = 0, lanes: int = 1, device=None,
            blt: tuple = (0, 0, 0)) -> int:
    """Threads a CTA of the launch :func:`variant` names (the row-split
    kernel takes 512 where one CTA fills an SM's shared memory, else 256)."""
    return _library().admm_chunk_threads(n, m, mg, *blt, lanes, _device_index(device))


def admm_chunk(Minv, A, q, l, u, rho, x, z, y, iters: int, sigma: float,
               alpha: float, row_structure: Optional[tuple] = None,
               E: Optional[torch.Tensor] = None,
               D: Optional[torch.Tensor] = None,
               out: Optional[_Tensors] = None) -> _Tensors:
    """Run ``iters`` ADMM iterations for every lane; returns (x, z, y), in
    ``out`` where given (three contiguous tensors shaped as x, z, y: a
    CUDA-graph replay's buffers).

    On CUDA tensors this launches the Hopper kernel once (or raises); on CPU
    tensors it runs :func:`admm_chunk_plain`, which takes the Ruiz scalings
    ``E``, ``D`` for a "blockdiag_shared" segment (the kernel reads those
    rows densely and needs neither)."""
    _check(Minv, A, q, l, u, rho, x, z, y)
    if out is not None:
        for name, o, t in zip("xzy", out, (x, z, y)):
            if o.shape != t.shape or o.dtype != t.dtype or o.device != t.device \
                    or not o.is_contiguous():
                raise ValueError(f"out's {name} must be a contiguous {tuple(t.shape)} "
                                 f"{t.dtype} tensor on {t.device}")
    if A.device.type == "cuda":
        return _launch(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha, row_structure,
                       out)
    if A.device.type == "cpu":
        res = admm_chunk_plain(Minv, A, q, l, u, rho, x, z, y, iters, sigma, alpha,
                               row_structure, E=E, D=D)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    raise ValueError(f"unsupported device {A.device}")


def make_admm_chunk_lanes(iters: int, sigma: float, alpha: float):
    """``chunk(Minv, A, q, l, u, rho, x, z, y, row_structure=None, E=None,
    D=None) → (x, z, y)``: :func:`admm_chunk` with ``iters``, ``sigma`` and
    ``alpha`` bound. The JAX factory builds a chunk for a lane that turns
    into the multi-lane kernel under ``vmap``; here every call is lanes
    first already, so the one kernel (or its plain version on a CPU tensor)
    takes the batch."""

    def chunk(Minv, A, q, l, u, rho, x, z, y, row_structure=None, E=None, D=None):
        return admm_chunk(Minv, A, q, l, u, rho, x, z, y, iters=iters, sigma=sigma,
                          alpha=alpha, row_structure=row_structure, E=E, D=D)

    return chunk
