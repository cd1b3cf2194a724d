"""The port's ADMM chunk (gpmpc_tpu_torch/ops/kernels/admm_chunk.py) against
the JAX Pallas kernels in interpret mode, on the CPU.

Tolerances are tests/test_pallas.py's: atol 3e-4 on x and z, 2e-3 on y
(duals on ρ-boosted equality rows amplify f32 reordering noise). The CUDA
kernel itself is compared with the plain version on the card by
chip_smoke.py and by tests/test_torch_cuda.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.pallas.admm_kernel import admm_chunk as jax_admm_chunk
from gpmpc_tpu.ops.pallas.admm_kernel import make_admm_chunk_lanes
from gpmpc_tpu.ops.qp import admm as JA
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

sys.path.insert(0, "tests")
from test_qp import random_qp  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ATOL_XZ, ATOL_Y = 3e-4, 2e-3


def _lane(seed, n=12, m=18):
    data = random_qp(np.random.default_rng(seed), n=n, m=m, eq_rows=4)
    rho_v = JA._rho_vec(data.l, data.u, jnp.asarray(0.1))
    Minv = JA._factor(data.P, data.A, rho_v, 1e-6)
    rng = np.random.default_rng(100 + seed)
    x = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
    z = data.A @ x
    y = jnp.asarray(rng.normal(size=m) * 0.01, jnp.float32)
    return (Minv, data.A, data.q, data.l, data.u, rho_v, x, z, y)


def _batch(seeds):
    lanes = [_lane(s) for s in seeds]
    return [np.stack([np.asarray(l[i]) for l in lanes]) for i in range(9)]


def _torch(args):
    return [torch.tensor(a) for a in args]


@pytest.mark.parametrize("iters", [1, 10])
def test_plain_matches_pallas_admm_chunk(iters):
    args = _batch(range(3))
    xt, zt, yt = K.admm_chunk_plain(*_torch(args), iters=iters, sigma=1e-6, alpha=1.6)
    for b in range(3):
        xj, zj, yj = jax_admm_chunk(*[jnp.asarray(a[b]) for a in args], iters=iters,
                                    sigma=1e-6, alpha=1.6, interpret=True)
        np.testing.assert_allclose(xt[b].numpy(), xj, atol=ATOL_XZ)
        np.testing.assert_allclose(zt[b].numpy(), zj, atol=ATOL_XZ)
        np.testing.assert_allclose(yt[b].numpy(), yj, atol=ATOL_Y)


def test_plain_matches_vmapped_lanes_kernel():
    args = _batch(range(4))
    chunk = make_admm_chunk_lanes(8, 1e-6, 1.6, interpret=True)
    xj, zj, yj = jax.jit(jax.vmap(chunk))(*[jnp.asarray(a) for a in args])
    xt, zt, yt = K.admm_chunk_plain(*_torch(args), iters=8, sigma=1e-6, alpha=1.6)
    np.testing.assert_allclose(xt.numpy(), xj, atol=ATOL_XZ)
    np.testing.assert_allclose(zt.numpy(), zj, atol=ATOL_XZ)
    np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL_Y)


def test_port_lanes_factory_matches_vmapped_lanes_kernel():
    """The port's ``make_admm_chunk_lanes`` (the wrapper with iters, σ and α
    bound) on a batch against the JAX factory under ``vmap``."""
    args = _batch(range(4))
    xj, zj, yj = jax.jit(jax.vmap(make_admm_chunk_lanes(8, 1e-6, 1.6, interpret=True)))(
        *[jnp.asarray(a) for a in args])
    xt, zt, yt = K.make_admm_chunk_lanes(8, 1e-6, 1.6)(*_torch(args))
    np.testing.assert_allclose(xt.numpy(), xj, atol=ATOL_XZ)
    np.testing.assert_allclose(zt.numpy(), zj, atol=ATOL_XZ)
    np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL_Y)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    args = _torch(_batch(range(2)))
    before = K.LAUNCHES
    out = K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6)
    ref = K.admm_chunk_plain(*args, iters=5, sigma=1e-6, alpha=1.6)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert K.LAUNCHES == before  # the counter counts kernel launches only


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_bad_operands(bad):
    args = _torch(_batch(range(2)))
    if bad == "shape":
        args[2] = args[2][:, :-1]
        with pytest.raises(ValueError, match="q must be"):
            K.admm_chunk(*args, iters=1, sigma=1e-6, alpha=1.6)
    else:
        args[0] = args[0].double()
        with pytest.raises(TypeError, match="float32"):
            K.admm_chunk(*args, iters=1, sigma=1e-6, alpha=1.6)


def test_pallas_available_false_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert not K.pallas_available()
    assert not K.pallas_available("cpu")


def _structured_qp(seed, n=12, m=18, nd=12, off=0.01):
    """random_qp with its first nd rows made diagonal, plus ``off``-scaled
    off-diagonal entries in those rows that a declared ("diag", nd) segment
    does not read."""
    rng = np.random.default_rng(seed)
    data = random_qp(rng, n=n, m=m, eq_rows=4)
    A = np.array(data.A)
    A[:nd] = off * rng.normal(size=(nd, n))
    A[np.arange(nd), np.arange(nd)] = 1.0 + 0.5 * rng.random(nd)
    return data.replace(A=jnp.asarray(A, jnp.float32))


@pytest.mark.parametrize("iters", [1, 10])
def test_plain_with_row_structure_matches_jax_streamed_solve(iters):
    """One chunk of the JAX solver's streamed path (use_pallas="off", no
    scaling, fixed ρ) with a declared diagonal segment whose rows also hold
    small off-diagonal entries: the plain chunk given the same structure
    reads the diagonal alone, as the JAX stream does."""
    segs = (("diag", 12), ("dense", 6))
    cfg = JA.ADMMConfig(max_iter=iters, check_interval=iters, scaling=0, adaptive_rho=False,
                        polish=False, infeas_certs=False, use_pallas="off", row_structure=segs)
    outs, ins = [], []
    for seed in range(3):
        data = _structured_qp(seed)
        rng = np.random.default_rng(100 + seed)
        x0 = jnp.asarray(rng.normal(size=12) * 0.1, jnp.float32)
        y0 = jnp.asarray(rng.normal(size=18) * 0.01, jnp.float32)
        outs.append(JA.solve(data, x0, y0, cfg))
        rho_v = JA._rho_vec(data.l, data.u, jnp.asarray(cfg.rho))
        Minv = JA._factor(data.P, data.A, rho_v, cfg.sigma)
        ins.append((Minv, data.A, data.q, data.l, data.u, rho_v, x0, data.A @ x0, y0))
    args = _torch([np.stack([np.asarray(l[i]) for l in ins]) for i in range(9)])
    kw = dict(iters=iters, sigma=cfg.sigma, alpha=cfg.alpha)
    xt, zt, yt = K.admm_chunk_plain(*args, row_structure=segs, **kw)
    for b, js in enumerate(outs):
        np.testing.assert_allclose(xt[b].numpy(), js.x, atol=ATOL_XZ)
        np.testing.assert_allclose(zt[b].numpy(), js.z, atol=ATOL_XZ)
        np.testing.assert_allclose(yt[b].numpy(), js.y, atol=ATOL_Y)
    # the off-diagonal entries are large enough to show: applied densely
    # they move the iterate well past the tolerance
    xd, zd, _ = K.admm_chunk_plain(*args, row_structure=None, **kw)
    assert float((zd - zt).abs().max()) > 10 * ATOL_XZ


def test_declared_dense_rows_match_pallas_lanes_kernel():
    """row_structure=None and an all-dense declaration are the function both
    Pallas kernels compute."""
    args = _batch(range(4))
    chunk = make_admm_chunk_lanes(8, 1e-6, 1.6, interpret=True)
    xj, zj, yj = jax.jit(jax.vmap(chunk))(*[jnp.asarray(a) for a in args])
    for segs in (None, (("dense", 18),), (("dense", 7), ("dense", 11))):
        xt, zt, yt = K.admm_chunk_plain(*_torch(args), iters=8, sigma=1e-6, alpha=1.6,
                                        row_structure=segs)
        np.testing.assert_allclose(xt.numpy(), xj, atol=ATOL_XZ)
        np.testing.assert_allclose(zt.numpy(), zj, atol=ATOL_XZ)
        np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL_Y)


@pytest.mark.parametrize("segs", [
    None,
    (("diag", 12),),
    (("diag", 12), ("dense", 6)),
    (("dense", 6), ("diag", 12)),
    (("diag", 8), ("dense", 2), ("diag", 5)),
    (("dense", 3), ("diag", 8), ("dense", 2), ("diag", 5)),
])
def test_kernel_layout_applies_the_declared_structure(segs):
    """The operands the CUDA kernel is handed (kernel_rows: the mg rows from
    row d0 on read as their diagonal, every other row dense, a further
    diagonal segment as dense rows holding its diagonal) give the plain
    chunk's function; the first diagonal segment costs no copy of A."""
    data = _structured_qp(5)
    rho_v = JA._rho_vec(data.l, data.u, jnp.asarray(0.1))
    Minv = JA._factor(data.P, data.A, rho_v, 1e-6)
    x = jnp.asarray(np.random.default_rng(7).normal(size=12) * 0.1, jnp.float32)
    args = _torch([np.asarray(a)[None] for a in
                   (Minv, data.A, data.q, data.l, data.u, rho_v, x, data.A @ x, jnp.zeros(18))])
    kw = dict(iters=5, sigma=1e-6, alpha=1.6)
    want = K.admm_chunk_plain(*args, row_structure=segs, **kw)
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    n_diag = sum(1 for s in segs or () if s[0] == "diag")
    assert (Ak is args[1]) == (n_diag <= 1)
    args[1] = Ak
    got = K.admm_chunk_plain(*args, row_structure=(("dense", d0), ("diag", mg)) if mg else None,
                             **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("segs,err", [
    ((("diag", 13),), ValueError),            # more diagonal rows than columns
    ((("dense", 19),), ValueError),           # more rows than A has
    ((("blockdiag", 2, 3, 5),), ValueError),  # blocks do not tile the 12 columns
    ((("band", 3),), ValueError),             # no such segment kind
])
def test_wrapper_rejects_unsupported_structure(segs, err):
    args = _torch(_batch(range(2)))
    with pytest.raises(err):
        K.admm_chunk(*args, iters=1, sigma=1e-6, alpha=1.6, row_structure=segs)
    with pytest.raises(err):
        K.kernel_rows(args[1], segs)


def _condensed_like_qp(seed, C=3, h=2, w=4, n_gu=2):
    """A QP in the condensed row order [state bounds (blt); control bounds
    (diag); facets (blockdiag_shared)] with A really of that structure."""
    rng = np.random.default_rng(seed)
    n = C * w
    blt = np.zeros((C * h, n))
    for i in range(C):
        blt[i * h:(i + 1) * h, :(i + 1) * w] = rng.normal(size=(h, (i + 1) * w))
    Gu = rng.normal(size=(n_gu, w))
    A = np.concatenate([blt, np.eye(n), np.kron(np.eye(C), Gu)])
    G = rng.normal(size=(n, n))
    m = A.shape[0]
    data = JA.QPData(*[jnp.asarray(a, jnp.float32) for a in (
        G @ G.T + 0.1 * np.eye(n), rng.normal(size=n), A, -1.0 - rng.random(m), 1.0 + rng.random(m))])
    return data, (("blt", C, h, w), ("diag", n), ("blockdiag_shared", C, n_gu, w))


@pytest.mark.parametrize("iters", [1, 10])
def test_plain_with_diag_after_blt_matches_jax_streamed_solve(iters):
    """One chunk with the condensed QP's row order, a diagonal segment after
    a "blt" one and shared facet blocks after it, Ruiz scaling on: the plain
    chunk on the JAX solver's scaled operands against one chunk of the JAX
    streamed solve, and against the dense reading of the same rows."""
    from gpmpc_tpu.ops.qp.ruiz import ruiz_equilibrate

    outs, ins = [], []
    for seed in range(3):
        data, segs = _condensed_like_qp(seed)
        cfg = JA.ADMMConfig(max_iter=iters, check_interval=iters, scaling=3, adaptive_rho=False,
                            polish=False, infeas_certs=False, use_pallas="off",
                            row_structure=segs)
        outs.append(JA.solve(data, config=cfg))
        sd, sc = ruiz_equilibrate(data, 3)
        rho_v = JA._rho_vec(sd.l, sd.u, jnp.asarray(cfg.rho))
        Minv = JA._factor(sd.P, sd.A, rho_v, cfg.sigma)
        z = jnp.zeros(data.m)
        ins.append((Minv, sd.A, sd.q, sd.l, sd.u, rho_v, jnp.zeros(data.n), z, z, sc.E, sc.D, sc.c))
    args = _torch([np.stack([np.asarray(l[i]) for l in ins]) for i in range(12)])
    E, D, c = args[9:]
    kw = dict(iters=iters, sigma=cfg.sigma, alpha=cfg.alpha)
    xt, zt, yt = K.admm_chunk_plain(*args[:9], row_structure=segs, E=E, D=D, **kw)
    for b, js in enumerate(outs):  # the JAX solve returns unscaled iterates
        np.testing.assert_allclose((D[b] * xt[b]).numpy(), js.x, atol=ATOL_XZ)
        np.testing.assert_allclose((zt[b] / E[b]).numpy(), js.z, atol=ATOL_XZ)
        np.testing.assert_allclose((E[b] * yt[b] / c[b]).numpy(), js.y, atol=ATOL_Y)
    xd, zd, yd = K.admm_chunk_plain(*args[:9], row_structure=None, **kw)
    torch.testing.assert_close(xt, xd, rtol=0, atol=ATOL_XZ)
    torch.testing.assert_close(yt, yd, rtol=0, atol=ATOL_Y)
    # the kernel takes the diagonal segment where it stands, after the 6 blt rows
    Ak, d0, mg = K.kernel_rows(args[1], segs)
    assert Ak is args[1] and (d0, mg) == (6, 12)
