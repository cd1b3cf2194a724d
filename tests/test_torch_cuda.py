"""The CUDA kernels (the ADMM chunk, the 3-DoF and 6-DoF fused rollouts and
linearizations, the safety filter's backup value and gradient) against
their plain PyTorch versions, on the card.

Marked ``cuda``: without a Hopper device every test skips. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

The chunk's tolerances are tests/test_pallas.py's (atol 3e-4 on x and z,
2e-3 on y), taken around a float64 run of the plain version and widened by
how far the float32 plain version itself lands from it: on ρ-boosted
equality rows f32 reordering noise alone moves the duals by up to 3.3e-3
after 50 iterations.
That widening is held to at most ten times the tolerance.
"""

import os

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.chunk_bench import (BOUNDED_SEGS, FLEET6_SEGS, LMPC_SEGS, chunk_inputs,
                                         filter_lanes, rollout_inputs, rollout_step, step64)
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import QPData, ruiz_equilibrate
from gpmpc_tpu_torch.ops.qp.admm import _factor, _rho_vec

pytestmark = pytest.mark.cuda

if not torch.cuda.is_available():
    torch.set_num_threads(1)  # the suite's CPU workers share the cores

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


def _golden_lanes(B, dev):
    reps = (B + 7) // 8
    return [torch.cat([a] * reps)[:B].contiguous() for a in _golden_args(dev)]


def _assert_matches_plain(args, segs, iters, scaled=False):
    """One launch of the wrapper against the plain version, around a float64
    run of it (see the module docstring). ``scaled`` takes the tolerances
    over max(1, max|reference|), as the smoke test does: a statement about
    f32 reordering for iterates far above 1 (the golden QP's reach 1.4e2 in
    x and 6.9e3 in y)."""
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
        if scaled:
            atol *= max(1.0, r.abs().max().item())
        assert bool(torch.isfinite(r).all()) and f32_noise <= 10 * atol, f32_noise
        torch.testing.assert_close(k.double(), r, rtol=0, atol=atol + f32_noise)


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
    (3, 300, 3100, (("dense", 1400), ("diag", 300), ("dense", 1400)), 5, "global"),
    (64, 60, 200, (("blt", 5, 28, 12), ("diag", 60)), 25, "shared"),  # state bounds kept
    (8, 24, 64, (("blt", 4, 8, 6), ("diag", 24), ("blockdiag", 4, 2, 6)), 25, "register"),
    (256, 10, 11, None, 25, "register"),                        # the hull projection's QP
    (256, 62, 168, (("blt", 5, 21, 9), ("diag", 45)), 25, "shared"),  # the LMPC hull QP's rows
    (4, 100, 150, (("diag", 100), ("dense", 50)), 25, "shared"),
    (4, 100, 120, None, 25, "shared"),
    (2, 300, 3000, None, 5, "global"),                          # a lane no cluster can hold
    (8, 207, 354, "golden", 50, "cluster"),                     # the sparse-form golden QP
    (4, 207, 354, "golden", 25, "cluster"),                     # a pretraining episode's chunk
], ids=["random", "main", "dense60", "mixed", "ragged", "ragged-mixed", "diag-later",
        "diag-middle", "diag-middle-shared", "diag-middle-global", "blt-diag",
        "blt-diag-blockdiag", "hull-projection", "lmpc-rows", "shared-mixed", "shared-dense", "global", "golden", "golden-b4"])
def test_kernel_matches_plain_version(cuda_device, B, n, m, segs, iters, want):
    if segs == "golden":
        args, segs = [a[:B] for a in _golden_args(cuda_device)], None
    else:
        args = _chunk_args(B, n, m, segs, cuda_device)
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    assert Ak is args[1]  # one diagonal segment, wherever it stands: no copy of A
    assert mg == next((s[1] for s in segs or () if s[0] == "diag"), 0)
    assert K.variant(n, m, mg, B) == want
    _assert_matches_plain(args, segs, iters)


@pytest.mark.parametrize("iters", [0, 1, 25])
@pytest.mark.parametrize("B", [1, 4, 5, 64])
def test_cluster_variant_on_the_golden_set(cuda_device, B, iters):
    """A lane's rows split over a cluster, at lane counts that change the
    cluster size (16 CTAs a lane for few lanes, the smallest that holds the
    lane for many) and at one that is a multiple of nothing."""
    args = _golden_lanes(B, cuda_device)
    assert K.variant(207, 354, 0, B) == "cluster"
    assert K.cluster_size(207, 354, 0, B) in (4, 8, 16)
    _assert_matches_plain(args, None, iters, scaled=True)


def test_cluster_size_may_change_between_calls(cuda_device):
    """Many lanes take the smallest cluster that holds a lane, few lanes a
    larger, non-portable one: the second launch must not inherit the first
    one's attributes."""
    small, large = K.cluster_size(207, 354, 0, 64), K.cluster_size(207, 354, 0, 4)
    assert small < large and large > 8
    _assert_matches_plain(_golden_lanes(64, cuda_device), None, 5, scaled=True)
    _assert_matches_plain(_golden_lanes(4, cuda_device), None, 5, scaled=True)
    _assert_matches_plain(_golden_lanes(64, cuda_device), None, 5, scaled=True)


@pytest.mark.parametrize("segs", [
    (("diag", 150), ("dense", 500)),
    (("dense", 237), ("diag", 150), ("dense", 263)),
    (("dense", 650),),
], ids=["diag-first", "diag-middle", "no-diag"])
@pytest.mark.parametrize("iters", [0, 1, 25])
def test_cluster_variant_with_a_diagonal_segment(cuda_device, segs, iters):
    """Ragged slices (150 columns, 500 or 650 dense rows over 4, 8 or 16
    CTAs) with the diagonal segment first, in the middle and absent."""
    args = _chunk_args(5, 150, 650, segs, cuda_device)
    mg = K.kernel_rows(args[1], segs)[2]
    assert K.variant(150, 650, mg, 5) == "cluster"
    _assert_matches_plain(args, segs, iters)


@pytest.mark.parametrize("n,m", [(300, 340), (600, 640)], ids=["n300", "n600"])
def test_cluster_variant_with_long_rows(cuda_device, n, m):
    """Rows beyond 256 columns are shared by 16 threads, beyond 512 by 32
    (a thread meets at most 8 float4 chunks of a row). Five iterations and
    scaled tolerances: at these sizes the plain f32 version itself moves
    away from the float64 run by more than the absolute tolerances within
    ten iterations."""
    segs = (("dense", 20), ("diag", n), ("dense", m - n - 20))
    args = _chunk_args(3, n, m, segs, cuda_device)
    assert K.variant(n, m, n, 3) == "cluster"
    _assert_matches_plain(args, segs, 5, scaled=True)


@pytest.mark.parametrize("declared", [True, False], ids=["blt-declared", "undeclared"])
@pytest.mark.parametrize("m,facet_rows", [(200, 0), (380, 36)], ids=["m200", "m380"])
def test_shared_variant_at_the_condensed_shapes(cuda_device, m, facet_rows, declared):
    """n = 60 with the state-bound rows kept (m = 200) and with facet rows
    behind the control rows (m = 380): the kernel agrees with the plain
    version whether or not the block-lower-triangular rows are declared."""
    full = (("blt", 5, 28, 12), ("diag", 60)) + ((("blt", 5, facet_rows, 12),) if facet_rows else ())
    args = _chunk_args(16, 60, m, full, cuda_device)
    segs = full if declared else (("dense", 140), ("diag", 60))
    assert K.variant(60, m, 60, 16) == "shared" and K.cluster_size(60, m, 60, 16) == 1
    _assert_matches_plain(args, segs, 25)


@pytest.mark.parametrize("iters", [0, 1, 30])
def test_shared_variant_at_the_sixdof_cycle_shape(cuda_device, iters):
    """Path D's chunk: 512 lanes of the 6-DoF condensed QP at its real data
    (n = 60, 140 attitude and rate bound rows declared "blt", then the 60
    control rows), 30 iterations a chunk. Scaled tolerances, as for the
    golden set: the iterates reach far above 1."""
    args = chunk_inputs("sixdof", torch.Generator(device="cuda").manual_seed(0), lanes=512)
    assert args[1].shape == (512, 200, 60)
    assert K.variant(60, 200, 60, 512) == "shared" and K.cluster_size(60, 200, 60, 512) == 1
    _assert_matches_plain(args, BOUNDED_SEGS, iters, scaled=True)


@pytest.mark.parametrize("declared", [False, True], ids=["as-the-path", "bounds-declared"])
@pytest.mark.parametrize("iters", [0, 1, 25])
@pytest.mark.parametrize("B", [4, 5])
def test_cluster_variant_at_the_sparse_6dof_shape(cuda_device, B, iters, declared):
    """The 6-DoF pretraining episodes' chunk at its real data: the sparse
    form of rti_config_6dof(N=15), n = 269, m = 224 equality rows then 269
    bound rows. The path declares no row structure (every row dense); the
    bound rows are the identity, so declaring them "diag" is exact too.
    Rows of 269 columns take 16 threads a dot product."""
    args = chunk_inputs("sparse6dof", torch.Generator(device="cuda").manual_seed(1), lanes=B)
    assert args[1].shape == (B, 493, 269)
    segs = (("dense", 224), ("diag", 269)) if declared else None
    mg = 269 if declared else 0
    assert K.variant(269, 493, mg, B) == "cluster"
    assert K.cluster_size(269, 493, mg, B) in (4, 8, 16)
    _assert_matches_plain(args, segs, iters, scaled=True)


@pytest.mark.parametrize("md,want", [(64, "register"), (65, "shared")])
def test_variants_meet_at_the_register_limit(cuda_device, md, want):
    """64 dense rows are the register variant's last shape; one more row
    takes the shared variant."""
    segs = (("dense", md - 30), ("diag", 60), ("dense", 30))
    args = _chunk_args(8, 60, 60 + md, segs, cuda_device)
    assert K.variant(60, 60 + md, 60, 8) == want
    _assert_matches_plain(args, segs, 25)


def test_kernel_picks_the_global_variant_when_smem_is_short(cuda_device):
    assert K.variant(60, 60, 60) == "register"
    assert K.variant(60, 124, 60) == "register"
    assert K.variant(60, 125, 60) == "shared"
    assert K.variant(60, 200, 60, 512) == "shared"
    assert K.variant(207, 354, 0, 4) == "cluster" and K.variant(207, 354, 0, 512) == "cluster"
    assert K.cluster_size(207, 354, 0, 4) > K.cluster_size(207, 354, 0, 512) >= 4
    # the two 6-DoF paths: the cycle's condensed QP and the episodes' sparse one
    assert K.variant(60, 200, 60, 512) == "shared" and K.cluster_size(60, 200, 60, 512) == 1
    for mg in (0, 269):
        assert K.variant(269, 493, mg, 4) == "cluster"
        assert K.cluster_size(269, 493, mg, 4) in (4, 8, 16)
    assert K.variant(300, 3000) == "global"  # 3.9 MB a lane: beyond 16 blocks
    with pytest.raises(ValueError, match="no variant"):
        K.variant(60, 60, 61)  # more diagonal rows than columns
    with pytest.raises(ValueError, match="no variant"):
        K.variant(60, 20000)  # the vectors alone exceed a block's shared memory


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


@pytest.mark.parametrize("iters", [1, 50])
def test_shared_variant_at_the_online_6dof_chunk(cuda_device, iters):
    """The 6-DoF online campaign's chunk (``sixdof50``): Path D's condensed
    QP at its real data in chunks of 50 iterations. The picker must keep the
    shared variant at 512 lanes."""
    args = chunk_inputs("sixdof", torch.Generator(device="cuda").manual_seed(0), lanes=512)
    assert K.variant(60, 200, 60, 512) == "shared" and K.cluster_size(60, 200, 60, 512) == 1
    _assert_matches_plain(args, BOUNDED_SEGS, iters, scaled=True)


def _to(obj, dev):
    """A (nested) dataclass of tensors copied to ``dev``."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def test_online_cycles_on_the_card_match_the_cpu(cuda_device):
    """Path E at 8 lanes: 30 cycles on the card, then 10 more from that
    state on the card and on the CPU, both on the card's flown transitions
    (the state it measures, the control it flew): u0 within 1e-3 on the nine
    cycles without a GP update, the posterior of the GPs refreshed at k = 39
    within 1% of its scale (a refit on the latest points is so
    ill-conditioned in f32 that two f32 runs need not agree on its u0 to
    1e-3: chip_smoke.py prints the CPU's own spread there), the buffer counts
    and the kernel's launches (one a cycle on the card, none on the CPU)."""
    import dataclasses

    from gpmpc_tpu_torch.main_path import fleet_x0, online_path

    op = online_path(cuda_device)
    (cinit, cstep), (_, cstep_c) = op.controller(), online_path("cpu").controller()
    xs = fleet_x0(8, cuda_device)
    st = cinit(xs)
    for k in range(30):
        u, st = cstep(st, xs, k)
        xs = op.F_true(xs, u)
    sc = _to(st, torch.device("cpu"))
    before = K.LAUNCHES
    for k in range(30, 40):
        u, st = cstep(st, xs, k)
        uc, sc = cstep_c(sc, xs.cpu(), k)
        if k < 39:
            torch.testing.assert_close(u.cpu(), uc, rtol=0, atol=1e-3)
        sc = dataclasses.replace(sc, u_prev=u.cpu())
        xs = op.F_true(xs, u)
    m_c = sc.gp.predict_gated(xs.cpu(), u.cpu())[0]
    torch.testing.assert_close(st.gp.predict_gated(xs, u)[0].cpu(), m_c, rtol=0,
                               atol=1e-2 * m_c.abs().max().item())
    assert K.LAUNCHES == before + 10
    assert torch.equal(st.gp.buffer_count.cpu(), sc.gp.buffer_count)
    assert torch.equal(st.n_refits.cpu(), sc.n_refits) and int(sc.n_refits[0]) == 4


def test_lane_batched_refit_on_the_card_matches_the_cpu(cuda_device):
    """The online refit's shape, 512 lanes × 3 outputs, 160 stored points
    (a different count a lane), 32 inducing points, 11 features, on a
    well-conditioned problem: the factors and the posterior at 1e-4."""
    from gpmpc_tpu_torch.gp import SquaredExponentialARD, predict_sparse_multi, refit_sparse_multi

    g = torch.Generator().manual_seed(3)
    B, cap, M, d, o = 512, 160, 32, 11, 3
    X, Z = torch.randn(B, cap, d, generator=g), torch.randn(B, M, d, generator=g)
    Y = torch.randn(B, o, cap, generator=g)
    mask = torch.arange(cap) < torch.randint(0, cap + 1, (B, 1), generator=g)
    k = SquaredExponentialARD(log_variance=0.2 * torch.randn(B, o, generator=g),
                              log_lengthscales=0.3 * torch.randn(B, o, d, generator=g) + 1.0)
    ln = torch.full((B, o), float(np.log(0.1)))
    Xq = torch.randn(B, 20, d, generator=g)
    cpu = refit_sparse_multi(k, Z, X, Y, mask, ln)
    dev = refit_sparse_multi(_to(k, cuda_device), Z.cuda(), X.cuda(), Y.cuda(), mask.cuda(),
                             ln.cuda())
    for name in ("Luu_inv", "LB_inv", "c"):
        torch.testing.assert_close(getattr(dev, name).cpu(), getattr(cpu, name), rtol=0,
                                   atol=1e-4)
    pc, pd = predict_sparse_multi(cpu, Xq), predict_sparse_multi(dev, Xq.cuda())
    torch.testing.assert_close(pd.mean.cpu(), pc.mean, rtol=0, atol=1e-4)
    torch.testing.assert_close(pd.variance.cpu(), pc.variance, rtol=0, atol=1e-4)


@pytest.mark.parametrize("iters", [0, 1, 25])
def test_cluster_variant_at_the_fleet_3dof_shape(cuda_device, iters):
    """Path F's 3-DoF chunk at its real data and width: 128 lanes of the
    sparse form of RTIConfig() (N = 15: n = 157, m = 112 equality rows then
    157 bound rows, no row declared), 25 iterations a chunk."""
    args = chunk_inputs("fleet3dof", torch.Generator(device="cuda").manual_seed(0), lanes=128)
    assert args[1].shape == (128, 269, 157)
    assert K.variant(157, 269, 0, 128) == "cluster"
    assert K.cluster_size(157, 269, 0, 128) in (2, 4, 8, 16)
    _assert_matches_plain(args, None, iters, scaled=True)


@pytest.mark.parametrize("iters", [0, 1, 25])
def test_shared_variant_at_the_fleet_6dof_shape(cuda_device, iters):
    """Path F's 6-DoF chunk at its real data and width: 64 lanes of the
    condensed rti_config_6dof(N=15) with every state bound kept (n = 45,
    210 rows declared "blt", then the 45 control rows), 25 iterations."""
    args = chunk_inputs("fleet6dof", torch.Generator(device="cuda").manual_seed(0), lanes=64)
    assert args[1].shape == (64, 255, 45)
    assert K.variant(45, 255, 45, 64) == "shared" and K.cluster_size(45, 255, 45, 64) == 1
    _assert_matches_plain(args, FLEET6_SEGS, iters, scaled=True)


def test_lane_batched_fit_on_the_card_matches_the_cpu(cuda_device):
    """The fleet's refit barrier: a 3-DoF GP per lane, 128 lanes of 128
    stored points (a different count a lane), fitted from the same k-means
    start rows on the card and on the CPU, at noise 0.1 (at the fleet's 1e-4
    the f32 posterior itself lands 4e-2 of its scale from float64; at 0.1,
    8e-5): the posterior within 5e-4 of its scale."""
    from gpmpc_tpu_torch.gp import Simple3DoFGP, StructuredGPConfig

    g = torch.Generator().manual_seed(5)
    B, cap = 128, 128
    gp = Simple3DoFGP.create(StructuredGPConfig(max_data_points=cap, n_inducing=24, noise=0.1),
                             device="cpu", lanes=B)
    X = torch.tensor([2.0, 20.0, 0.5, -0.5, -3.0, 0.2, 0.1]) + torch.randn(B, cap, 7, generator=g)
    U = torch.tensor([2.0, 0.0, 0.0]) + 0.3 * torch.randn(B, cap, 3, generator=g)
    R = 0.3 * torch.tanh(X[..., 4:7])
    valid = torch.arange(cap) < torch.randint(40, cap + 1, (B, 1), generator=g)
    gp = gp.add_data_batch_masked(X, U, R, valid)
    idx = torch.argsort(torch.rand(B, cap, generator=g) - 2.0 * gp.buffer.mask, dim=1)[:, :24]
    cpu = gp.fit(init_idx=idx)
    dev = _to(gp, cuda_device).fit(init_idx=idx.cuda())
    Xq, Uq = X[:, :20], U[:, :20]
    mc, vc = cpu.predict(Xq, Uq)
    md, vd = dev.predict(Xq.cuda(), Uq.cuda())
    torch.testing.assert_close(md.cpu(), mc, rtol=0, atol=5e-4 * mc.abs().max().item())
    torch.testing.assert_close(vd.cpu(), vc, rtol=0, atol=5e-4 * vc.abs().max().item())


def _assert_within_witness(args, segs, iters, x=2.0):
    """Real data whose f32 plain run lies beyond ten times the tolerance
    from its float64 run (the LMPC hull QP, the hull projection): the
    kernel lies no farther from the float64 run than the tolerance plus
    ``x`` times the plain f32 run's own distance (chip_smoke.py's rule for
    these shapes)."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6, row_structure=segs)
    kern = K.admm_chunk(*args, **kw)
    plain = K.admm_chunk_plain(*args, **kw)
    ref = K.admm_chunk_plain(*[a.double() for a in args], **kw)
    for k, p, r, atol in zip(kern, plain, ref, (3e-4, 3e-4, 2e-3)):
        atol *= max(1.0, r.abs().max().item())
        f32 = (p.double() - r).abs().max().item()
        assert bool(torch.isfinite(k).all())
        assert (k.double() - r).abs().max().item() <= atol + x * f32


@pytest.mark.parametrize("kind,iters", [("lmpc", 1), ("lmpc", 25), ("hull", 1), ("hull", 25)])
def test_lmpc_and_hull_shapes_at_real_data(cuda_device, kind, iters):
    """The fleet-LMPC ADMM arm's hull QP (256 lanes, n = 62, m = 105 blt +
    45 diag + 18 dense rows: the shared variant, not the global one) and
    the hull projection's QP (256 lanes, n = 10, m = 11: register) at their
    real data, held by the witness rule."""
    args = chunk_inputs(kind, torch.Generator(device="cuda").manual_seed(0), lanes=256)
    B, m, n = args[1].shape
    segs = LMPC_SEGS if kind == "lmpc" else None
    want = {"lmpc": "shared", "hull": "register"}[kind]
    assert K.variant(n, m, 45 if kind == "lmpc" else 0, B) == want
    _assert_within_witness(args, segs, iters)


@pytest.mark.parametrize("iters", [1, 25])
@pytest.mark.parametrize("B", [512, 1024])
def test_register_variant_at_the_filter_shape(cuda_device, B, iters):
    """The safety filter's intervention QP at its real data and the
    campaigns' widths (n = 4, m = 6, every row dense): the register
    variant, against the plain chunk."""
    args = chunk_inputs("filter", torch.Generator(device="cuda").manual_seed(0), lanes=B)
    assert args[1].shape == (B, 6, 4)
    assert K.variant(4, 6, 0, B) == "register"
    _assert_matches_plain(args, None, iters)


def test_safety_filter_on_the_card_matches_the_cpu(cuda_device):
    """``filter_control`` of the rescue campaign's filter on 256 lanes under
    the downdraft: the card (the chunk kernel) and the CPU (the plain chunk)
    intervene on the same lanes outside 1e-4·α of the threshold, and their
    controls agree within 1e-3 there; every filter QP launches the kernel
    (4 chunks × 2 SCP iterations)."""
    from gpmpc_tpu_torch.main_path import safety_rescue_path
    from gpmpc_tpu_torch.safety import filter_control

    x, u = filter_lanes(256, torch.Generator(device="cuda").manual_seed(1), cuda_device)
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        sp = safety_rescue_path(dev)
        before = K.LAUNCHES
        out[dev] = filter_control(sp.F_filter, sp.backup, sp.invariant, sp.filter_config,
                                  x.to(dev), u.to(dev))
        launches[dev] = K.LAUNCHES - before
    gpu, cpu = out["cuda"], out["cpu"]
    alpha = sp.invariant.alpha
    clear = ((cpu.lyapunov_value - alpha).abs() > 1e-4 * alpha)
    assert int((~cpu.safe).sum()) > 20
    assert torch.equal(gpu.intervened.cpu()[clear], cpu.intervened[clear])
    torch.testing.assert_close(gpu.u.cpu()[clear], cpu.u[clear], rtol=0, atol=1e-3)
    assert launches == {"cuda": 8, "cpu": 0}


def _landed_lanes(B, dev):
    """Lanes at rest on the ground (h = 0 and below, v = 0) under nominal,
    zero and braking thrust, as a rescue campaign's frozen lanes meet the
    filter."""
    x = torch.tensor([2.0, 0.0, 0.1, -0.2, 0.0, 0.0, 0.0], device=dev).repeat(B, 1)
    x[1::2, 1] = -0.05
    u = torch.tensor([[2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [6.5, 0.3, -0.2]], device=dev)
    return x, u.repeat(B // 3 + 1, 1)[:B].contiguous()


# The backup-value kernel against the autograd route, both float32, held by
# the witness rule: within twice the autograd route's own distance from a
# float64 run of it, or 1e-6 of the lane's scale where float32 lands closer.
# Measured on an H100 (80GB HBM3, 700 W) at 1,024 lanes over five draws and
# the landed lanes: the kernel lies ≤ 2.1e-6 (V, relative) and ≤ 3.5e-7 (∂V/∂u,
# of its lane's scale) from the autograd route; from the float64 run the
# kernel ≤ 2.7e-6 and 6.3e-7, the autograd route ≤ 2.6e-6 and 9.5e-7.
BACKUP_WITNESS_X, BACKUP_FLOOR = 2.0, 1e-6


@pytest.mark.parametrize("draw", ["filter_lanes0", "filter_lanes1", "filter_lanes2", "landed"])
def test_backup_value_kernel_matches_autograd(cuda_device, draw):
    """V and ∂V/∂u of the rescue filter (the downdraft model, emergency
    braking, the funnel, N = 5) at 1,024 lanes: one launch, and within the
    witness rule of the autograd route on the same inputs."""
    from gpmpc_tpu_torch.chunk_bench import filter_value64
    from gpmpc_tpu_torch.main_path import safety_rescue_path
    from gpmpc_tpu_torch.ops.kernels import backup_value as BV
    from gpmpc_tpu_torch.safety.safety_filter import _value_and_grad

    sp = safety_rescue_path(cuda_device)
    if draw == "landed":
        x, u = _landed_lanes(1024, cuda_device)
    else:
        x, u = filter_lanes(1024, torch.Generator(device=cuda_device).manual_seed(int(draw[-1])),
                            cuda_device)
    args = (sp.F_filter, sp.backup, sp.invariant, sp.filter_config.N)
    assert BV.fused(*args[:3], x)
    before = BV.LAUNCHES
    got = BV.backup_value_grad(*args, x, u)
    assert BV.LAUNCHES == before + 1
    f32 = _value_and_grad(*args, x, u)
    f64 = filter_value64(sp, x, u)
    torch.cuda.synchronize()
    for what, k, p, r in zip(("V", "dV/du"), got, f32, f64):
        scale = r.abs().reshape(r.shape[0], -1).amax(1).clamp_min(1.0)
        rel = lambda t: ((t.double() - r).abs().reshape(r.shape[0], -1).amax(1) / scale)
        witness = rel(p).max().item()
        lim = max(BACKUP_WITNESS_X * witness, BACKUP_FLOOR)
        err = rel(k).max().item()
        assert k.shape == p.shape and bool(torch.isfinite(k).all()), what
        assert err <= lim, (f"{what}: kernel {err:.3e} from the float64 run, autograd f32 "
                            f"{witness:.3e}, limit {lim:.3e}; kernel vs autograd "
                            f"{(rel(k) - rel(p)).abs().max().item():.3e}")


def test_filtered_step_launches_the_backup_kernel_twice(cuda_device):
    """Each step of the rescue campaign's filtered controller at 1,024 lanes
    launches the backup-value kernel exactly twice (the check's evaluation,
    which is the first SCP iteration's, and the second SCP iteration's)."""
    from gpmpc_tpu_torch.main_path import filtered_controller, safety_rescue_path
    from gpmpc_tpu_torch.ops.kernels import backup_value as BV

    sp = safety_rescue_path(cuda_device)
    finit, fstep = filtered_controller(sp)
    x, _ = filter_lanes(1024, torch.Generator(device=cuda_device).manual_seed(3), cuda_device)
    x[:, 1] += 2.0
    state = finit(x)
    for k in range(3):
        before = BV.LAUNCHES
        u, state = fstep(state, x, k)
        assert BV.LAUNCHES == before + 2, k
        x = sp.plant(x, u)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


def _feasible_qps(B, n=16, m=30, n_eq=3, seed=0):
    """tests/test_ipm.py's random feasible QPs (one-sided rows, the last
    n_eq rows equalities), B of them, float64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        Ph = rng.normal(size=(n, n))
        A = rng.normal(size=(m, n))
        Az = A @ (rng.normal(size=n) * 0.5)
        l = Az - np.abs(rng.normal(size=m)) - 0.05
        u = Az + np.abs(rng.normal(size=m)) + 0.05
        l[0], u[1] = -np.inf, np.inf
        l[-n_eq:] = u[-n_eq:] = Az[-n_eq:]
        out.append((Ph @ Ph.T + np.eye(n), rng.normal(size=n), A, l, u))
    return out


def test_ipm_on_the_card_matches_the_cpu(cuda_device):
    """The interior-point solver on 64 random feasible QPs and on the LMPC
    hull QPs of 256 lanes: the card's x within 4e-3 of the CPU's
    (tests/test_ipm.py:92's batched floor), the same status, no host sync
    needed to freeze a lane (a non-PD lane freezes on the card as well)."""
    from gpmpc_tpu_torch.chunk_bench import lmpc_qp
    from gpmpc_tpu_torch.ops.qp import IPMConfig, solve_ipm

    qps = _feasible_qps(64)
    qps[5] = (-1e3 * np.eye(16),) + qps[5][1:]
    data = QPData(*[torch.tensor(np.stack([q[i] for q in qps]), dtype=torch.float32)
                    for i in range(5)])
    cfg = IPMConfig(n_eq=3, iters=25)
    cpu = solve_ipm(data, cfg)
    dev = solve_ipm(QPData(*[t.cuda() for t in (data.P, data.q, data.A, data.l, data.u)]), cfg)
    torch.testing.assert_close(dev.x.cpu(), cpu.x, rtol=0, atol=4e-3)
    # the status is a threshold on the residuals: a lane at it may part
    # (one of 64 did on an H100, its x within the tolerance all the same)
    assert int((dev.status.cpu() != cpu.status).sum()) <= 2
    assert int(dev.iterations[5]) == int(cpu.iterations[5]) == 0
    assert int(dev.status[5]) == int(cpu.status[5]) != 0
    hull = lmpc_qp(256, torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"))
    perm = torch.tensor(list(range(150)) + list(range(158, 168)) + list(range(150, 158)))
    hull = QPData(hull.P, hull.q, hull.A[:, perm], hull.l[:, perm], hull.u[:, perm])
    # the hull QPs: card vs CPU per lane within 4e-3 of the iterate's scale,
    # or twice the CPU's own spread under a 1e-7 relative change of q, on
    # all but 2% of the lanes: the freeze (μ and stationarity thresholds)
    # and acceptance are thresholds, and a lane at one parts (1 of 256 did
    # on an H100, beyond 2e-2)
    hcfg = IPMConfig(n_eq=8, iters=20)
    hd = solve_ipm(hull, hcfg)
    hcpu = QPData(*[t.cpu() for t in (hull.P, hull.q, hull.A, hull.l, hull.u)])
    hc = solve_ipm(hcpu, hcfg)
    q1 = hcpu.q * (1 + 1e-7 * torch.randn(hcpu.q.shape, generator=torch.Generator().manual_seed(0)))
    ho = solve_ipm(QPData(hcpu.P, q1, hcpu.A, hcpu.l, hcpu.u), hcfg)
    scale = hc.x.abs().amax(-1).clamp_min(1.0)
    lim = torch.maximum(4e-3 * scale, 2.0 * (ho.x - hc.x).abs().amax(-1))
    assert bool(torch.isfinite(hd.x).all())
    assert float(((hd.x.cpu() - hc.x).abs().amax(-1) <= lim).float().mean()) >= 0.98
    assert float((hd.status.cpu() == hc.status).float().mean()) > 0.95


def test_knn_on_the_card_matches_the_cpu(cuda_device):
    """The lanes-first KNN over a 65,536-row store (256 lanes, a fuel budget
    each, the fallback on): the same neighbours by state and Q, squared
    distances within rtol 1e-4 plus 1e-3, the f32 cancellation floor of
    ‖a‖²+‖b‖²−2a·b at weighted norms² ≈ 4e2 (a few ulps of 8e2)."""
    from gpmpc_tpu_torch.terminal import SafeSet, knn_query

    g = torch.Generator().manual_seed(0)
    ss = SafeSet.create(65536, 7, device="cpu")
    X = torch.randn(400, 150, 7, generator=g) + torch.tensor([2.0, 20, 0, 0, -2, 0, 0])
    ss = ss.add_trajectories(X, torch.randn(400, 150, 3, generator=g),
                             torch.rand(400, 150, generator=g))
    xq = X[:256, 40] + 0.05 * torch.randn(256, 7, generator=g)
    fuel = torch.rand(256, generator=g) - 0.2
    rc = knn_query(ss, xq, 10, fuel_available=fuel, fallback_unfiltered=True)
    ssd = SafeSet(**{k: (v.cuda() if torch.is_tensor(v) else v) for k, v in vars(ss).items()})
    rd = knn_query(ssd, xq.cuda(), 10, fuel_available=fuel.cuda(), fallback_unfiltered=True)
    assert torch.equal(rd.valid.cpu(), rc.valid)
    torch.testing.assert_close(rd.distances.cpu() ** 2, rc.distances ** 2, rtol=1e-4, atol=1e-3)
    same = rd.indices.cpu() == rc.indices
    assert float(same.float().mean()) > 0.99  # near-ties may swap
    torch.testing.assert_close(rd.q_values.cpu()[same], rc.q_values[same])


@pytest.mark.parametrize("iters", [1, 25])
@pytest.mark.parametrize("kind,lanes,want", [("suite_gp", 256, "shared"), ("suite_gp", 64, "shared"),
                                             ("suite_rti", 256, "cluster"),
                                             ("suite_rti", 64, "cluster"), ("scvx", 704, "cluster")])
def test_experiment_suite_and_scvx_shapes_at_real_data(cuda_device, kind, lanes, want, iters):
    """The experiment suite's two MPC QPs at their real data, at its 256
    runs and the dispersion sweep's 64 lanes — GP-MPC's condensed QP at
    N = 15 with every state bound kept (n = 45, m = 105 blt + 45 diag:
    LMPC_SEGS), the RTI ablation's sparse form (n = 157, m = 269 dense) —
    and the SCVX library's first subproblem (704 lanes, n = 407, m = 694
    dense), none on the global variant, against the plain chunk."""
    args = chunk_inputs(kind, torch.Generator(device="cuda").manual_seed(0), lanes=lanes)
    B, m, n = args[1].shape
    segs = LMPC_SEGS if kind == "suite_gp" else None
    assert (B, n, m) == {"suite_gp": (lanes, 45, 150), "suite_rti": (lanes, 157, 269),
                         "scvx": (704, 407, 694)}[kind]
    assert K.variant(n, m, 45 if segs else 0, B) == want
    _assert_matches_plain(args, segs, iters, scaled=True)


def test_scvx_on_the_card_matches_the_cpu(cuda_device):
    """SCVX at N = 40 (15 SCP iterations, each a batched solve through the
    cluster variant) for 2 of the suite's initial states at t_f = 8 s, card
    against CPU: X, U and fuel within 1e-3 or twice the CPU's own spread
    under a 1e-7 relative change of x0; converged equal."""
    from gpmpc_tpu_torch.main_path import experiments_x0, scvx_library_path
    from gpmpc_tpu_torch.reference import scvx_solve

    cpu = torch.device("cpu")
    lg, lc = scvx_library_path("cuda"), scvx_library_path(cpu)
    x0 = experiments_x0(2, "cuda")
    g = scvx_solve(lg.step_dt, lg.config, x0, lg.x_target, 0.2)
    c = scvx_solve(lc.step_dt, lc.config, x0.cpu(), lc.x_target, 0.2)
    gen = torch.Generator().manual_seed(0)
    o = scvx_solve(lc.step_dt, lc.config, x0.cpu() * (1 + 1e-7 * torch.randn(2, 7, generator=gen)),
                   lc.x_target, 0.2)
    for k in ("X", "U", "fuel_used"):
        d = (getattr(g, k).cpu() - getattr(c, k)).abs().max().item()
        w = (getattr(o, k) - getattr(c, k)).abs().max().item()
        assert d <= max(1e-3, 2.0 * w), (k, d, w)
    assert torch.equal(g.converged.cpu(), c.converged) and bool(c.converged.all())


def _golden_qp(dev, lanes=8):
    fx = np.load(GOLDEN)
    names = (("canonical", "high_fast", "low_slow", "lateral") * lanes)[:lanes]
    return QPData(*[torch.tensor(np.stack([fx[f"{s}/{p}"] for s in names]), dtype=torch.float32,
                                 device=dev) for p in ("P", "q", "A", "l", "u")])


def test_warm_kkt_solve_on_the_card_matches_the_cpu(cuda_device):
    """``solve(kkt_inv0=)`` on the sparse golden QPs (8 lanes): a perturbed
    KKT inverse refreshed by Newton–Schulz under a fixed scaling, 50
    iterations through the cluster variant, card against CPU: the refreshed
    inverse within 1e-4 of its scale, x within 1e-3 or twice the CPU's own
    spread under a 1e-7 relative change of the inverse."""
    from gpmpc_tpu_torch.ops.qp import ADMMConfig, solve

    cpu = torch.device("cpu")
    data = _golden_qp(cpu)
    sd, sc = ruiz_equilibrate(data, 3)
    X = _factor(sd.P, sd.A, _rho_vec(sd.l, sd.u, torch.full((8,), 0.1)), 1e-6)
    g = torch.Generator().manual_seed(0)
    X0 = X * (1 + 1e-3 * torch.randn(X.shape, generator=g))
    cfg = ADMMConfig(max_iter=50, polish=False, adaptive_rho=False, infeas_certs=False)
    to = lambda t: t.to(cuda_device)
    sol_g = solve(QPData(*[to(getattr(data, k)) for k in "P q A l u".split()]), config=cfg,
                  fixed_scaling=type(sc)(*[to(t) for t in sc]), kkt_inv0=to(X0))
    sol_c = solve(data, config=cfg, fixed_scaling=sc, kkt_inv0=X0)
    sol_o = solve(data, config=cfg, fixed_scaling=sc,
                  kkt_inv0=X0 * (1 + 1e-7 * torch.randn(X.shape, generator=g)))
    scale = sol_c.kkt_inv.abs().max().item()
    assert (sol_g.kkt_inv.cpu() - sol_c.kkt_inv).abs().max().item() <= 1e-4 * scale
    d = (sol_g.x.cpu() - sol_c.x).abs().max().item()
    w = (sol_o.x - sol_c.x).abs().max().item()
    assert d <= max(1e-3, 2.0 * w), (d, w)


def test_bf16_streamed_solve_on_the_card_matches_the_cpu(cuda_device):
    """``matvec_dtype="bf16"`` on the streamed path (``use_pallas="off"``)
    with the f32 tail, on the condensed QP with its state-bound rows (blt +
    diag) at eps 1e-5, card against CPU: after the tail both reach the f32
    fixed point, x within 1e-3 of each other and of the f32 solve (the CPU
    lands 7e-5 from it)."""
    from gpmpc_tpu_torch.ops.qp import ADMMConfig, solve

    cpu = torch.device("cpu")
    args = chunk_inputs("bounded", torch.Generator(device="cuda").manual_seed(0), lanes=0)
    Minv, A = args[0][:8].cpu(), args[1][:8].cpu()
    P = torch.linalg.inv(Minv) - (A.transpose(1, 2) * args[5][:8].cpu()[:, None]) @ A
    data = QPData(P=0.5 * (P + P.transpose(1, 2)), q=args[2][:8].cpu(), A=A,
                  l=args[3][:8].cpu(), u=args[4][:8].cpu())
    kw = dict(adaptive_rho=False, infeas_certs=False, use_pallas="off", scaling=0,
              row_structure=BOUNDED_SEGS, eps_abs=1e-5, eps_rel=1e-5)
    bf = ADMMConfig(max_iter=50, check_interval=50, matvec_dtype="bf16", tail_f32_iters=400, **kw)
    f32 = solve(data, config=ADMMConfig(max_iter=800, check_interval=50, **kw))
    sol_c = solve(data, config=bf)
    sol_g = solve(QPData(*[getattr(data, k).to(cuda_device) for k in "P q A l u".split()]),
                  config=bf)
    assert (sol_g.x.cpu() - sol_c.x).abs().max().item() <= 1e-3
    assert (sol_g.x.cpu() - f32.x).abs().max().item() <= 1e-3


WITNESS_X = 2.0  # chip_smoke.py's witness rule

# A QP with a "blt" segment whose last block row is clipped at n: 7 block
# rows of 6 rows, 23 columns a block column, n = 150 (the last keeps 150 of
# its 161), the segment placed first, after dense rows and after the
# diagonal rows; 10 dense rows follow in each layout.
BLT_LAYOUTS = {
    "blt-first": (("blt", 7, 6, 23), ("diag", 150), ("dense", 10)),
    "blt-after-dense": (("dense", 5), ("blt", 7, 6, 23), ("diag", 150), ("dense", 5)),
    "blt-after-diag": (("diag", 150), ("blt", 7, 6, 23), ("dense", 10)),
}


@pytest.mark.parametrize("push", [1, 0], ids=["push", "pull"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", sorted(BLT_LAYOUTS))
def test_blt_segment_on_each_cluster_size(cuda_device, layout, cluster, push):
    """The "blt" segment read as its kept entries alone, on the shared
    variant (one CTA a lane) and on clusters of 2, 4 and 8 CTAs, with the
    partials pushed into the peers or pulled from them, through the tile
    build (csrc/admm_chunk_tiles.cu: the same kernel with the tiling taken
    per call), against the plain chunk with the same row structure. The
    declared zero blocks hold 0.01-sized entries that the kernel must not
    read. Each tiling sums in its own order, so the kernel is held around
    the float64 run by the witness rule (chip_smoke.py): within the
    tolerance plus twice the plain f32 run's own distance from it (the duals
    of the two ρ-boosted equality rows carry ~5e-3 of f32 noise after 25
    iterations; a cluster of 8 landed 1.06e-2 from the float64 run where
    the plain f32 run lands 5.2e-3)."""
    from gpmpc_tpu_torch.chunk_bench import _tiles_library, rows_chunk

    segs = BLT_LAYOUTS[layout]
    args = _chunk_args(5, 150, 202, segs, cuda_device, seed=cluster)
    t0 = K.kernel_blt(segs, 202)[0]
    noise = torch.zeros_like(args[1])
    for i in range(7):  # entries inside the declared zero blocks
        noise[:, t0 + 6 * i:t0 + 6 * (i + 1), min(23 * (i + 1), 150):] = 0.01
    args[1] = args[1] + noise
    kw = dict(iters=25, sigma=1e-6, alpha=1.6, row_structure=segs)
    lib = _tiles_library()
    got = rows_chunk(lib, 256, 8, cluster, args, segs, 25, push)
    ref = K.admm_chunk_plain(*[a.double() for a in args], **kw)
    plain = K.admm_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    for k, p, r, atol in zip(got, plain, ref, (3e-4, 3e-4, 2e-3)):
        f32_noise = (p.double() - r).abs().max().item()
        assert f32_noise <= 10 * atol
        torch.testing.assert_close(k.double(), r, rtol=0, atol=atol + WITNESS_X * f32_noise)


@pytest.mark.parametrize("layout", sorted(BLT_LAYOUTS))
def test_wrapper_reads_the_blt_segment(cuda_device, layout):
    """The port's own launch with the segment declared, no copy of A."""
    segs = BLT_LAYOUTS[layout]
    args = _chunk_args(5, 150, 202, segs, cuda_device)
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    assert Ak is args[1] and mg == 150 and K.kernel_blt(segs, 202)[1:] == (7, 6, 23)
    assert K.variant(150, 202, 150, 5, blt=(7, 6, 23)) in ("shared", "cluster")
    _assert_matches_plain(args, segs, 25)


@pytest.mark.parametrize("iters", [0, 1, 25])
@pytest.mark.parametrize("kind,lanes", [("golden", 4), ("golden", 5), ("golden", 512),
                                        ("sparse6dof", 4), ("sparse6dof", 5),
                                        ("suite_rti", 256), ("suite_rti", 64),
                                        ("fleet3dof", 128), ("scvx", 704)])
def test_sparse_form_with_its_rows_declared(cuda_device, kind, lanes, iters):
    """The sparse-form shapes at their real data with the rows the paths now
    declare (("blt", N+1, n_x, n_x+n_u), ("diag", nz)): none on the global
    variant, suite_rti and fleet3dof on the shared variant, against the
    plain chunk with the same structure (scaled tolerances: the iterates
    reach far above 1)."""
    from gpmpc_tpu_torch.chunk_bench import sparse_segs

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "golden":
        args = _golden_lanes(lanes, cuda_device)
    else:
        args = chunk_inputs(kind, gen, lanes=lanes)
    segs = sparse_segs(kind)
    B, m, n = args[1].shape
    blt = K.kernel_blt(segs, m)
    assert blt[0] == 0 and blt[1] * blt[2] + n == m
    v = K.variant(n, m, n, B, blt=blt[1:])
    assert v == ("shared" if kind in ("suite_rti", "fleet3dof") else "cluster")
    _assert_matches_plain(args, segs, iters, scaled=True)


# The fused rollout and linearization kernels (csrc/rollout_linearize.cu for
# the 3-DoF rocket, csrc/rollout_linearize6dof.cu for the 6-DoF one). Each
# output is held around a float64 run of the plain version: within twice the
# float32 plain version's own distance from that run (the witness rule), or
# 1e-6 of the output's scale where float32 lands closer still.
ROLLOUT_WITNESS_X, ROLLOUT_FLOOR = 2.0, 1e-6
ROLLOUT_MODELS = ("3dof", "6dof")


def _assert_rollout_matches_plain(step, x0, U, tape):
    from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL

    before = dict(RL.LAUNCHES)
    got = RL.rollout_linearize(step, x0, U, tape)
    name = RL.kernel_name(type(step))
    assert RL.LAUNCHES == {**before, name: before[name] + 1}
    f32 = RL.rollout_linearize_plain(step, x0, U, tape)
    f64 = RL.rollout_linearize_plain(step64(step), x0.double(), U.double(),
                                     None if tape is None else tape.double())
    torch.cuda.synchronize()
    for what, k, p, r in zip(("X", "A", "B", "c"), got, f32, f64):
        assert k.shape == p.shape and bool(torch.isfinite(k).all()), what
        witness = (p.double() - r).abs().max().item()
        lim = max(ROLLOUT_WITNESS_X * witness, ROLLOUT_FLOOR * max(1.0, r.abs().max().item()))
        err = (k.double() - r).abs().max().item()
        assert err <= lim, (f"{what}: kernel {err:.3e} from the float64 run, plain f32 "
                            f"{witness:.3e}, limit {lim:.3e}; kernel vs plain "
                            f"{(k - p).abs().max().item():.3e}")


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
@pytest.mark.parametrize("plant", [False, True], ids=["nominal", "plant"])
@pytest.mark.parametrize("model,B", [("3dof", 512), ("3dof", 4096), ("6dof", 512)])
def test_rollout_linearize_kernel_matches_plain(cuda_device, model, B, plant, tape):
    """20 knots at the GP-MPC cells' lanes: 512 and 4,096 for the 3-DoF
    rocket, Path D's 512 for the 6-DoF one."""
    x0, U, T = rollout_inputs(model, B, 20, cuda_device)
    _assert_rollout_matches_plain(rollout_step(model, cuda_device, plant), x0, U,
                                  T if tape else None)


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("model", ROLLOUT_MODELS)
def test_rollout_linearize_kernel_on_a_ragged_block(cuda_device, model, B):
    """Lane counts that leave a block's lanes partly empty, at N = 3."""
    x0, U, T = rollout_inputs(model, B, 3, cuda_device, seed=1)
    _assert_rollout_matches_plain(rollout_step(model, cuda_device, True), x0, U, T)


@pytest.mark.parametrize("model", ROLLOUT_MODELS)
def test_path_launches_its_rollout_kernel_once_a_cycle(cuda_device, model):
    """The path's cycle at 512 lanes with a stand-in GP (main_path() for the
    3-DoF rocket, sixdof_path() for the 6-DoF one): one launch a cycle of
    the model's rollout kernel and none of the other's; u0 and X_opt within
    the card-vs-CPU 1e-3 of the eager route (a lambda of the same step) from
    the same state, on every lane of the main path and on all but 1% of Path
    D's. A 6-DoF lane meets two threshold tests a cycle: ADMM freezes it at
    the check after 30 iterations if it passes the termination test there,
    and its plan is accepted or its rollout flown. Float32 rounding alone
    moves a lane that lies on either threshold across: on Path D's fleet the
    eager route itself, under one-ulp changes of the state, parts on 0-2
    lanes a cycle by up to 0.36, and the kernel route from it on 0-3. A fault
    of the kernel would move every lane's plan; its outputs themselves are
    held by the witness rule above."""
    from gpmpc_tpu_torch.main_path import fleet_x0, main_path, sixdof_fleet_x0, sixdof_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
    from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL

    def mean(X, U):
        out = torch.zeros_like(X)
        out[..., 4:7] = 0.05 * torch.tanh(0.1 * X[..., 4:7] + 0.01 * U)
        if model == "6dof":
            out[..., 11:14] = 0.02 * torch.tanh(X[..., 11:14] + 0.01 * U)
        return out

    n_gp = 3 if model == "3dof" else 6
    var = lambda X, U: torch.full((*X.shape[:-1], n_gp), 1e-3, device=X.device)
    lanes = 512
    if model == "3dof":
        path, xs, parted_max = main_path(cuda_device), fleet_x0(lanes, cuda_device), 0
    else:
        path = sixdof_path(cuda_device)
        xs = sixdof_fleet_x0(torch.Generator(device=cuda_device).manual_seed(7), lanes,
                             cuda_device)
        parted_max = lanes // 100
    name = RL.kernel_name(type(path.F))
    state = gp_mpc_init(path.config, xs, path.x_target, device=cuda_device)
    eager = lambda x, u: path.F(x, u)
    for cycle in range(3):
        before = dict(RL.LAUNCHES)
        sol, new_state = gp_mpc_solve(path.F, mean, var, path.config, state, xs)
        assert RL.LAUNCHES == {**before, name: before[name] + 1}
        ref, _ = gp_mpc_solve(eager, mean, var, path.config, state, xs)
        assert RL.LAUNCHES == {**before, name: before[name] + 1}  # the lambda: eager
        torch.cuda.synchronize()
        d = torch.maximum((sol.u0 - ref.u0).abs().amax(1),
                          (sol.X_opt - ref.X_opt).abs().amax((1, 2)))
        parted = int((d > 1e-3).sum())
        assert parted <= parted_max, (
            f"cycle {cycle}: {parted} lanes beyond 1e-3 in u0 or X_opt (max {d.max().item():.3e}, "
            f"median {d.median().item():.3e})")
        state, xs = new_state, path.F_true(xs, sol.u0)


# The main path's cycle replayed from CUDA-graph segments (mpc/cycle_replay.py):
# from the third call at a key on, against the eager route (the same GP
# behind callables that declare no frozen posterior) on the same inputs. The
# replay runs the same kernels in the same order, so the two agree bit for bit
# (every output, at 512 and 4,096 lanes and over 8 closed-loop cycles, on an
# H100).

def _replay_setup(dev, lanes=512, path="main"):
    """The main path (or Path C: its bounded QP, m = 200, and the gust's
    variance on the GP's) with the main cells' exploration GP."""
    from gpmpc_tpu_torch.learning import explore_gp_3dof
    from gpmpc_tpu_torch.main_path import (calibration_path, fleet_x0, main_path,
                                           with_gust_variance)
    from gpmpc_tpu_torch.mpc import gp_mpc_init

    mp = main_path(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    gp, mean_fn, var_fn = explore_gp_3dof(g, g, mp.params, mp.F_true, dt=0.1, n_points=128,
                                          n_inducing=48, device=dev)
    if path == "calibration":
        mp, var_fn = calibration_path(dev), with_gust_variance(var_fn)
    xs = fleet_x0(lanes, dev)
    return mp, gp, mean_fn, var_fn, gp_mpc_init(mp.config, xs, mp.x_target, device=dev), xs


def _outputs(sol, state):
    return {"u0": sol.u0, "X": sol.X_opt, "U": sol.U_opt, "Sigma": sol.Sigmas,
            "cost": sol.cost, "converged": sol.converged, "success": sol.success,
            "X_lin": state.X_lin, "U_lin": state.U_lin, "rho": state.rho, "y": state.y_prev}


def _assert_same(got, want, what=""):
    for k, w in want.items():
        assert torch.equal(got[k], w), f"{what}{k}: {(got[k].double() - w.double()).abs().max()}"


@pytest.mark.parametrize("path", ["main", "calibration"])
def test_replayed_cycle_is_the_eager_cycle(cuda_device, path):
    from gpmpc_tpu_torch.mpc import cycle_replay as R
    from gpmpc_tpu_torch.mpc import gp_mpc_solve

    mp, _, mean_fn, var_fn, state, xs = _replay_setup(cuda_device, path=path)
    eager_mean, eager_var = (lambda x, u: mean_fn(x, u)), (lambda x, u: var_fn(x, u))
    captures, replays = R.CAPTURES, R.REPLAYS
    for _ in range(3):  # eager, recorded, replayed
        got = _outputs(*gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs))
    assert (R.CAPTURES, R.REPLAYS) == (captures + 1, replays + 1)
    posterior = R.EAGER.get("posterior", 0)
    want = _outputs(*gp_mpc_solve(mp.F, eager_mean, eager_var, mp.config, state, xs))
    assert R.EAGER["posterior"] == posterior + 1
    _assert_same(got, want)


def test_replayed_results_belong_to_the_caller(cuda_device):
    """What a replayed call returned is unchanged after three more calls
    from other states."""
    from gpmpc_tpu_torch.mpc import gp_mpc_solve

    mp, _, mean_fn, var_fn, state, xs = _replay_setup(cuda_device)
    for _ in range(3):
        sol, new_state = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
    kept = _outputs(sol, new_state)
    copies = {k: v.clone() for k, v in kept.items()}
    st, x = new_state, xs
    for _ in range(3):
        s, st = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, st, x)
        x = mp.F_true(x, s.u0)
    torch.cuda.synchronize()
    _assert_same(kept, copies, "kept ")
    assert new_state.x_ref is state.x_ref  # carried over, as the eager cycle carries it


def test_replay_launches_the_chunk_kernel_once_a_cycle_and_never_waits(cuda_device):
    from gpmpc_tpu_torch.mpc import cycle_replay as R
    from gpmpc_tpu_torch.mpc import gp_mpc_solve
    from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL

    mp, _, mean_fn, var_fn, state, xs = _replay_setup(cuda_device)
    for _ in range(2):
        gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
    chunk, roll, replays = K.LAUNCHES, dict(RL.LAUNCHES), R.REPLAYS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert R.REPLAYS == replays + 4
    assert K.LAUNCHES == chunk + 4
    assert RL.LAUNCHES == {**roll, "rollout_linearize": roll["rollout_linearize"] + 4}


def test_new_gp_callables_are_recorded_anew(cuda_device):
    from gpmpc_tpu_torch.learning import gp_fns
    from gpmpc_tpu_torch.mpc import cycle_replay as R
    from gpmpc_tpu_torch.mpc import gp_mpc_solve

    mp, gp, mean_fn, var_fn, state, xs = _replay_setup(cuda_device)
    for _ in range(3):
        first = _outputs(*gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs))
    mean2, var2 = gp_fns(gp)
    captures, first_calls = R.CAPTURES, R.EAGER.get("first_call", 0)
    for _ in range(3):
        again = _outputs(*gp_mpc_solve(mp.F, mean2, var2, mp.config, state, xs))
    assert R.CAPTURES == captures + 1 and R.EAGER["first_call"] == first_calls + 1
    _assert_same(again, first)


def test_replayed_closed_loop_is_the_eager_loop(cuda_device):
    """Eight cycles of the main path's closed loop at 512 lanes, replayed
    against eager: the plant under each route's own u0. Within the witness
    rule (PERF.md §6) trivially: the two loops fly the same bits."""
    from gpmpc_tpu_torch.mpc import gp_mpc_solve

    mp, _, mean_fn, var_fn, state, xs = _replay_setup(cuda_device)
    eager_mean, eager_var = (lambda x, u: mean_fn(x, u)), (lambda x, u: var_fn(x, u))
    s1 = s2 = state
    x1 = x2 = xs
    for cycle in range(8):
        a, s1 = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, s1, x1)
        b, s2 = gp_mpc_solve(mp.F, eager_mean, eager_var, mp.config, s2, x2)
        _assert_same(_outputs(a, s1), _outputs(b, s2), f"cycle {cycle}: ")
        x1, x2 = mp.F_true(x1, a.u0), mp.F_true(x2, b.u0)
