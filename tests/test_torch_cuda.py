"""The CUDA chunk kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a Hopper device every test skips. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances are tests/test_pallas.py's (atol 3e-4 on x and z, 2e-3 on y),
taken around a float64 run of the plain version and widened by how far the
float32 plain version itself lands from it: on ρ-boosted equality rows f32
reordering noise alone moves the duals by up to 3.3e-3 after 50 iterations.
That widening is held to at most ten times the tolerance.
"""

import os

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import QPData, ruiz_equilibrate
from gpmpc_tpu_torch.ops.qp.admm import _factor, _rho_vec

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "qp_golden.npz")


@pytest.fixture
def cuda_device():
    if not K.pallas_available():
        pytest.skip("needs a Hopper (sm_90) CUDA device; run on the card")
    return torch.device("cuda")


def _chunk_args(B, n, m, segs, dev, seed=0):
    """Operands of a scaled random QP whose A follows ``segs``: a declared
    "diag" segment is a random diagonal, a "dense" segment random rows, "blt"
    and "blockdiag" segments random within their blocks and zero outside. M⁻¹
    is factored from that A; then the diag segments get small off-diagonal
    entries, which the chunk must ignore (applied, they would break the
    match between M⁻¹ and the operator and the iteration would diverge)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = rng.normal(size=(B, m, n))
    off = np.zeros((B, m, n))
    r0 = 0
    for seg in segs or ():
        kind, nr = seg[0], K._seg_rows(seg)
        if kind == "diag":
            off[:, r0:r0 + nr] = 0.01 * A[:, r0:r0 + nr]
            off[:, np.arange(nr) + r0, np.arange(nr)] = 0.0
            A[:, r0:r0 + nr] = 0.0
            A[:, np.arange(nr) + r0, np.arange(nr)] = 1.0 + 0.5 * rng.random(size=(B, nr))
        elif kind == "blt":  # block row i keeps its first (i+1)·w columns
            _, C, h, w = seg
            for i in range(C):
                A[:, r0 + i * h:r0 + (i + 1) * h, (i + 1) * w:] = 0.0
        elif kind == "blockdiag":  # block row i keeps columns i·w .. (i+1)·w
            _, nb, h, w = seg
            for i in range(nb):
                A[:, r0 + i * h:r0 + (i + 1) * h, :i * w] = 0.0
                A[:, r0 + i * h:r0 + (i + 1) * h, (i + 1) * w:] = 0.0
        r0 += nr
    lo = -np.abs(rng.normal(size=(B, m))) - 0.5
    hi = np.abs(rng.normal(size=(B, m))) + 0.5
    lo[:, :2] = hi[:, :2] = 0.3  # equality rows: ρ boosted ×1e3
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    args = _scaled(QPData(P=t(P), q=t(rng.normal(size=(B, n))), A=t(A), l=t(lo), u=t(hi)), rng)
    args[1] = args[1] + t(off)
    return args


def _scaled(data, rng):
    dev = data.A.device
    B, m, n = data.A.shape
    sd, _ = ruiz_equilibrate(data, 2)
    rho = _rho_vec(sd.l, sd.u, torch.full((B,), 0.1, device=dev))
    Minv = _factor(sd.P, sd.A, rho, 1e-6)
    x = torch.tensor(0.1 * rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    z = torch.bmm(sd.A, x[:, :, None])[:, :, 0]
    y = torch.tensor(0.01 * rng.normal(size=(B, m)), dtype=torch.float32, device=dev)
    return [Minv, sd.A.contiguous(), sd.q, sd.l, sd.u, rho, x, z, y]


def _golden_args(dev):
    fx = np.load(GOLDEN)
    names = ("canonical", "high_fast", "low_slow", "lateral") * 2
    t = lambda p: torch.tensor(np.stack([fx[f"{s}/{p}"] for s in names]),
                               dtype=torch.float32, device=dev)
    return _scaled(QPData(*[t(p) for p in ("P", "q", "A", "l", "u")]), np.random.default_rng(0))


@pytest.mark.parametrize("B,n,m,segs,iters,want", [
    (4, 12, 18, None, 25, "register"),                          # test_pallas.py's random QP
    (512, 60, 60, (("diag", 60),), 50, "register"),             # the main path
    (16, 60, 60, None, 50, "register"),                         # dense at the main-path size
    (8, 60, 100, (("diag", 60), ("dense", 40)), 50, "register"),  # diagonal + dense rows
    (8, 57, 57, (("diag", 57),), 50, "register"),               # ragged n
    (8, 57, 70, (("diag", 57),), 50, "register"),               # ragged n, trailing dense rows
    (8, 40, 60, (("dense", 10), ("diag", 30)), 25, "register"),  # diagonal segment not first
    (8, 40, 70, (("dense", 10), ("diag", 30), ("dense", 30)), 25, "register"),  # ... in the middle
    (6, 90, 200, (("dense", 70), ("diag", 60), ("dense", 70)), 25, "shared"),
    (3, 100, 800, (("dense", 350), ("diag", 100), ("dense", 350)), 10, "global"),
    (64, 60, 200, (("blt", 5, 28, 12), ("diag", 60)), 25, "shared"),  # state bounds kept
    (8, 24, 64, (("blt", 4, 8, 6), ("diag", 24), ("blockdiag", 4, 2, 6)), 25, "register"),
    (4, 100, 150, (("diag", 100), ("dense", 50)), 25, "shared"),
    (4, 100, 120, None, 25, "shared"),
    (3, 100, 700, None, 10, "global"),                          # too big for shared memory
    (8, 207, 354, "golden", 50, "global"),                      # the sparse-form golden QP
    (4, 207, 354, "golden", 25, "global"),                      # a pretraining episode's chunk
], ids=["random", "main", "dense60", "mixed", "ragged", "ragged-mixed", "diag-later",
        "diag-middle", "diag-middle-shared", "diag-middle-global", "blt-diag",
        "blt-diag-blockdiag", "shared-mixed", "shared-dense", "global", "golden", "golden-b4"])
def test_kernel_matches_plain_version(cuda_device, B, n, m, segs, iters, want):
    if segs == "golden":
        args, segs = [a[:B] for a in _golden_args(cuda_device)], None
    else:
        args = _chunk_args(B, n, m, segs, cuda_device)
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    assert Ak is args[1]  # one diagonal segment, wherever it stands: no copy of A
    assert mg == next((s[1] for s in segs or () if s[0] == "diag"), 0)
    assert K.variant(n, m, mg) == want
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6, row_structure=segs)
    before = K.LAUNCHES
    kern = K.admm_chunk(*args, **kw)
    plain = K.admm_chunk_plain(*args, **kw)
    ref = K.admm_chunk_plain(*[a.double() for a in args], **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    for k, p, r, atol in zip(kern, plain, ref, (3e-4, 3e-4, 2e-3)):
        f32_noise = (p.double() - r).abs().max().item()
        # the widening stays far below the iterates: a diverging iteration,
        # whose f32 noise grows with it, fails here instead of passing
        assert bool(torch.isfinite(r).all()) and f32_noise <= 10 * atol, f32_noise
        torch.testing.assert_close(k.double(), r, rtol=0, atol=atol + f32_noise)


def test_kernel_picks_the_global_variant_when_smem_is_short(cuda_device):
    assert K.variant(60, 60, 60) == "register"
    assert K.variant(60, 124, 60) == "register"
    assert K.variant(60, 125, 60) == "shared"
    assert K.variant(207, 354) == "global"
    with pytest.raises(ValueError, match="no variant"):
        K.variant(60, 60, 61)  # more diagonal rows than columns


def test_second_diagonal_segment_is_applied_through_a_copy(cuda_device):
    """Only the first "diag" segment goes through the kernel's diagonal; a
    further one is handed over as dense rows holding its diagonal, so its
    off-diagonal entries are still ignored."""
    segs = (("diag", 20), ("dense", 5), ("diag", 15))
    args = _chunk_args(8, 20, 40, segs, cuda_device)
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    assert Ak is not args[1] and (d0, mg) == (0, 20)
    kw = dict(iters=25, sigma=1e-6, alpha=1.6, row_structure=segs)
    kern = K.admm_chunk(*args, **kw)
    ref = K.admm_chunk_plain(*[a.double() for a in args], **kw)
    for k, r, atol in zip(kern, ref, (3e-4, 3e-4, 2e-3)):
        torch.testing.assert_close(k.double(), r, rtol=0, atol=10 * atol)


def test_wrapper_leaves_inputs_untouched(cuda_device):
    args = _chunk_args(8, 20, 30, (("diag", 20),), cuda_device)
    saved = [a.clone() for a in args]
    K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6, row_structure=(("diag", 20),))
    torch.cuda.synchronize()
    for a, b in zip(args, saved):
        assert torch.equal(a, b)
