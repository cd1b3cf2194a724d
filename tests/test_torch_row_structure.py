"""The sparse form's row structure, declared by the port's sparse-form
solves (``mpc/rti.py::_sparse_admm_cfg``: ("blt", N+1, n_x, n_x+n_u) for x₀'s
identity and the dynamics rows, ("diag", nz) for the variable bounds), against
the QPs the builders make and against the JAX package on the CPU, which
solves the same QPs with A dense.

- The declared blocks cover A's zero pattern exactly: every entry outside
  them is 0.0 (the 3-DoF form at N = 15 and 20, the 6-DoF one, with facet
  rows appended, ``scvx_qp``).
- ``admm_chunk_plain`` with the structure against the same chunk with A
  dense: the same sums in another order, so tests/test_pallas.py's
  tolerances (3e-4 on x and z, 2e-3 on y) over max(1, max|iterate|).
- The port's ``solve`` with the structure against JAX ``solve`` with it and
  with JAX's dense default, on the golden sparse QPs at tests/test_qp.py's
  settings: both packages' u0 within 1e-3 of the certified optimum, the
  JAX test's bound, so within 2e-3 of each other.
- Each sparse-form call site hands the structure to the solver, a user-set
  structure wins, and one sparse RTI cycle and a 3-lane SCVX solve match
  their JAX twins (tests/test_torch_rti.py's 5e-4 on u0 and the plan;
  tests/test_torch_reference.py's witness rule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import reference as JREF
from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.mpc import rti as JR
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig, admm as JA
from gpmpc_tpu_torch import convert, reference as TREF
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.mpc import gp_mpc as TG, rti as TR, rti_config_6dof
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import (ADMMConfig, QPData, build_mpc_qp, build_stage_rows,
                                    extend_qp, ruiz_equilibrate, split_z)
from gpmpc_tpu_torch.ops.qp import admm as TA

torch.set_num_threads(1)  # the suite's xdist workers share the cores

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qp_golden.npz")
SCENARIOS = ("canonical", "high_fast", "low_slow", "lateral")
XT = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)
DT = 0.1
ATOL_XZ, ATOL_Y = 3e-4, 2e-3


def _declared(segs, m, n):
    """(m, n) bool: the entries the row structure may hold — a "blt" block
    row i its first min((i+1)·w, n) columns, a "diag" row its diagonal
    entry, rows past the segments whole."""
    keep = np.zeros((m, n), bool)
    r0 = 0
    for seg in segs:
        if seg[0] == "blt":
            _, C, h, w = seg
            for i in range(C):
                keep[r0 + i * h:r0 + (i + 1) * h, :min((i + 1) * w, n)] = True
        else:
            assert seg[0] == "diag"
            keep[r0 + np.arange(seg[1]), np.arange(seg[1])] = True
        r0 += K._seg_rows(seg)
    keep[r0:] = True
    return keep


def _sparse_qp(N, n_x, facets=False, B=3, seed=0):
    """The sparse-form QP of ``build_mpc_qp`` with dense random Jacobians
    (every entry of A_k and B_k nonzero), optionally with glideslope-like
    state facets and cone-like control facets appended (``extend_qp``)."""
    g = torch.Generator().manual_seed(seed)
    n_u = 3
    Aks = torch.eye(n_x) + 0.1 * torch.randn(B, N, n_x, n_x, generator=g)
    Bks = 0.1 * torch.randn(B, N, n_x, n_u, generator=g)
    cks = 0.01 * torch.randn(B, N, n_x, generator=g)
    x0 = torch.randn(B, n_x, generator=g)
    x_ref = torch.zeros(B, N + 1, n_x)
    data = build_mpc_qp(Aks, Bks, cks, x0, torch.eye(n_x), 0.1 * torch.eye(n_u),
                        10.0 * torch.eye(n_x), x_ref, -50.0 * torch.ones(n_x),
                        50.0 * torch.ones(n_x), -5.0 * torch.ones(n_u), 5.0 * torch.ones(n_u))
    if facets:
        Gx = torch.zeros(2, n_x)
        Gx[0, 1], Gx[0, 2], Gx[1, 1], Gx[1, 3] = -1.0, 1.0, -1.0, 1.0
        Gu = torch.tensor([[-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]])
        data = extend_qp(data, *build_stage_rows(N, n_x, n_u, Gx, torch.full((2,), -1e20),
                                                 torch.ones(2), Gu, torch.full((2,), -1e20),
                                                 torch.zeros(2)))
    return data


def _scvx_qp(N=6):
    cfg = TREF.SCVXConfig(N=N, iterations=2, device="cpu")
    P = Rocket3DoFParams(device="cpu")
    x0 = torch.tensor([[2.0, 25.0, 1.0, -0.5, -3.0, 0.0, 0.0],
                       [1.95, 22.0, -1.5, 0.8, -2.5, 0.2, -0.1]])
    U = torch.zeros(2, N, 3)
    U[:, :, 0] = 1.9
    data, _ = TREF.scvx.scvx_qp(lambda x, u, dt: tr.step(P, x, u, dt), cfg, x0,
                                torch.tensor(XT), torch.tensor([0.8, 1.0]), U)
    return cfg, data


CASES = {
    "3dof-N15": lambda: (TR.RTIConfig(N=15, device="cpu"), _sparse_qp(15, 7)),
    "3dof-N20": lambda: (TR.RTIConfig(N=20, device="cpu"), _sparse_qp(20, 7)),
    "6dof-N15": lambda: (rti_config_6dof(Rocket6DoF(), N=15, device="cpu"), _sparse_qp(15, 14)),
    "3dof-facets": lambda: (TR.RTIConfig(N=15, device="cpu"), _sparse_qp(15, 7, facets=True)),
    "scvx": _scvx_qp,
}


def Rocket6DoF():
    from gpmpc_tpu_torch.dynamics import Rocket6DoFParams

    return Rocket6DoFParams(device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_declared_blocks_cover_every_nonzero(case):
    cfg, data = CASES[case]()
    segs = TR._sparse_admm_cfg(cfg).row_structure
    N, n_x, n_u = cfg.N, cfg.n_x, cfg.n_u
    assert segs == (("blt", N + 1, n_x, n_x + n_u), ("diag", (N + 1) * n_x + N * n_u))
    A = data.A.numpy()
    B, m, n = A.shape
    assert n == segs[1][1] and m >= sum(K._seg_rows(s) for s in segs)
    outside = ~_declared(segs, m, n)
    assert (A[:, outside] == 0.0).all()
    # the last block row is the one clipped at n: its last row reaches column
    # n − 1 (x_N's −I)
    assert (A[:, (N + 1) * n_x - 1, n - 1] == -1.0).all()
    assert K.kernel_blt(segs, m) == (0, N + 1, n_x, n_x + n_u)
    assert K.kernel_rows(data.A, segs)[1:] == ((N + 1) * n_x, n)


def _chunk_operands(data):
    sd, _ = ruiz_equilibrate(data, 2)
    B, m, n = sd.A.shape
    rho = TA._rho_vec(sd.l, sd.u, torch.full((B,), 0.1))
    Minv = TA._factor(sd.P, sd.A, rho, 1e-6)
    g = torch.Generator().manual_seed(1)
    x = 0.1 * torch.randn(B, n, generator=g)
    z = torch.bmm(sd.A, x[:, :, None])[:, :, 0]
    y = 0.01 * torch.randn(B, m, generator=g)
    return [Minv, sd.A, sd.q, sd.l, sd.u, rho, x, z, y]


@pytest.mark.parametrize("iters", [1, 25])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chunk_with_the_structure_matches_dense(case, iters):
    cfg, data = CASES[case]()
    segs = TR._sparse_admm_cfg(cfg).row_structure
    args = _chunk_operands(data)
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    got = K.admm_chunk_plain(*args, row_structure=segs, **kw)
    want = K.admm_chunk_plain(*args, row_structure=None, **kw)
    for a, b, atol in zip(got, want, (ATOL_XZ, ATOL_XZ, ATOL_Y)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=atol * max(1.0, b.abs().max().item()))
    # the wrapper on CPU tensors is the plain version with the same structure
    for a, b in zip(K.admm_chunk(*args, row_structure=segs, **kw), got):
        assert torch.equal(a, b)


def _golden():
    fx = np.load(FIXTURE)
    stack = lambda p: np.stack([fx[f"{s}/{p}"] for s in SCENARIOS]).astype(np.float32)
    return fx, [stack(p) for p in ("P", "q", "A", "l", "u")]


@pytest.mark.parametrize("jax_rows", ["declared", "dense"])
def test_solve_with_the_structure_matches_jax(jax_rows):
    fx, arrs = _golden()
    segs = TR._sparse_row_structure(20, 7, 3)
    cfg = ADMMConfig(max_iter=400, polish=True, row_structure=segs)
    sol = TA.solve(QPData(*[torch.tensor(a) for a in arrs]), config=cfg)
    _, U = split_z(sol.x, 20, 7, 3)
    jcfg = JaxADMMConfig(max_iter=400, polish=True, use_pallas="off",
                         row_structure=segs if jax_rows == "declared" else None)
    for b, s in enumerate(SCENARIOS):
        js = JA.solve(JA.QPData(*[jnp.asarray(a[b]) for a in arrs]), config=jcfg)
        U_j = np.asarray(js.x)[:-7].reshape(20, 10)[:, 7:]
        U_star = np.asarray(fx[f"{s}/x_star"], np.float32)[:-7].reshape(20, 10)[:, 7:]
        assert int(sol.status[b]) == TA.SOLVED or float(sol.pri_res[b]) < 1e-2
        np.testing.assert_allclose(U[b, 0].numpy(), U_star[0], atol=1e-3)
        np.testing.assert_allclose(U_j[0], U_star[0], atol=1e-3)
        np.testing.assert_allclose(U[b, 0].numpy(), U_j[0], atol=2e-3)


def _record_structures(monkeypatch, module):
    """Every row structure ``module.solve`` is called with, in order."""
    seen = []
    real = module.solve

    def spy(data, *a, **kw):
        cfg = a[2] if len(a) > 2 else kw.get("config")
        seen.append(cfg.row_structure)
        return real(data, *a, **kw)

    monkeypatch.setattr(module, "solve", spy)
    return seen


def _jax_port_configs(**kw):
    """tests/test_torch_rti.py's sparse configuration at N = 6."""
    jcfg = JR.RTIConfig(N=6, admm=JaxADMMConfig(max_iter=100, polish=True, use_pallas="off"),
                        **kw)
    d = {f: (np.asarray(v) if hasattr(v, "shape") else v)
         for f, v in ((f.name, getattr(jcfg, f.name)) for f in jcfg.__dataclass_fields__.values())}
    d["admm"] = {f: getattr(jcfg.admm, f) for f in jcfg.admm.__dataclass_fields__}
    return jcfg, convert.rti_config_from_fields(d, device="cpu")


def _x0s(B=3):
    x0s = np.tile(np.array([2.0, 12.0, 0.5, -0.5, -3.0, 0.2, 0.0], np.float32), (B, 1))
    x0s[:, 1] += np.linspace(0.0, 3.0, B, dtype=np.float32)
    return x0s


def test_sparse_rti_cycle_declares_the_rows_and_matches_jax(monkeypatch):
    jcfg, cfg = _jax_port_configs()
    assert cfg.admm.row_structure is None and not cfg.condensed
    seen = _record_structures(monkeypatch, TR)
    x0s = _x0s()
    jF = lambda x, u: jr.step(JaxParams(), x, u, DT)
    P = Rocket3DoFParams(device="cpu")
    tF = lambda x, u: tr.step(P, x, u, DT)
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(XT)))(jnp.asarray(x0s))
    sj, _ = jax.vmap(lambda s, x: JR.rti_step(jF, jcfg, s, x))(js, jnp.asarray(x0s))
    st, _ = TR.rti_step(tF, cfg, TR.rti_init(cfg, x0s, XT), torch.tensor(x0s))
    assert seen == [TR._sparse_row_structure(6, 7, 3)]
    np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
    np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4)
    np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=5e-4)


def test_a_user_set_structure_wins(monkeypatch):
    _, cfg = _jax_port_configs()
    mine = (("dense", 49), ("diag", 67))
    cfg = cfg.replace(admm=cfg.admm.replace(row_structure=mine))
    assert TR._sparse_admm_cfg(cfg).row_structure == mine
    seen = _record_structures(monkeypatch, TR)
    P = Rocket3DoFParams(device="cpu")
    x0s = _x0s(2)
    TR.rti_step(lambda x, u: tr.step(P, x, u, DT), cfg, TR.rti_init(cfg, x0s, XT),
                torch.tensor(x0s))
    assert seen == [mine]


@pytest.mark.parametrize("warm_kkt", [False, True], ids=["cholesky", "warm-kkt"])
def test_sparse_gp_mpc_declares_the_rows(monkeypatch, warm_kkt):
    """The sparse GP-MPC branch (two SCP iterations) and its warm-KKT init
    hand the solver and ``init_kkt_carry`` the structure; the carry itself
    does not depend on it (its scaling and inverse are of the whole A)."""
    base = TR.RTIConfig(N=6, device="cpu",
                        admm=ADMMConfig(max_iter=50, polish=False, adaptive_rho=False))
    cfg = TG.GPMPCConfig(base=base, scp_iterations=2, warm_kkt=warm_kkt)
    seen = _record_structures(monkeypatch, TG)
    carried = []
    real_carry = TG.init_kkt_carry

    def carry_spy(data, admm):
        carried.append(admm.row_structure)
        out = real_carry(data, admm)
        plain = real_carry(data, admm.replace(row_structure=None))
        for k in out:
            assert torch.equal(out[k], plain[k])
        return out

    monkeypatch.setattr(TG, "init_kkt_carry", carry_spy)
    P = Rocket3DoFParams(device="cpu")
    F = lambda x, u: tr.step(P, x, u, DT)
    zero = lambda X, U: torch.zeros_like(X)
    x0s = torch.tensor(_x0s(2))
    st = TG.gp_mpc_init(cfg, x0s, torch.tensor(XT), step_fn=F, device="cpu")
    sol, _ = TG.gp_mpc_solve(F, zero, lambda X, U: torch.full_like(X, 1e-4), cfg, st, x0s)
    want = TR._sparse_row_structure(6, 7, 3)
    assert seen == [want, want]
    assert carried == ([want] if warm_kkt else [])
    assert bool(torch.isfinite(sol.u0).all())


def test_scvx_declares_the_rows_and_matches_jax(monkeypatch):
    """Three lanes at N = 10 (tests/test_torch_reference.py's settings), held
    by its witness rule."""
    seen = _record_structures(monkeypatch, TREF.scvx)
    jc = JREF.SCVXConfig(N=10, iterations=4, admm=JaxADMMConfig(max_iter=200, polish=True))
    tc = TREF.SCVXConfig(N=10, iterations=4, admm=ADMMConfig(max_iter=200, polish=True),
                         device="cpu")
    x0 = np.repeat(np.array([[2.0, 25.0, 1.0, -0.5, -3.0, 0.0, 0.0]], np.float32), 3, axis=0)
    dts = np.array([0.5, 0.7, 0.9], np.float32)
    J = JaxParams()
    ref = jax.jit(jax.vmap(lambda x, dt: JREF.scvx_solve(
        lambda s, u, h: jr.step(J, s, u, h), jc, x, jnp.asarray(XT), dt)))(
        jnp.asarray(x0), jnp.asarray(dts))
    P = Rocket3DoFParams(device="cpu")
    fn = lambda x: TREF.scvx_solve(lambda s, u, h: tr.step(P, s, u, h), tc, x,
                                   torch.tensor(XT), torch.tensor(dts))
    out = fn(torch.tensor(x0))
    assert seen[:4] == [TR._sparse_row_structure(10, 7, 3)] * 4
    gen = torch.Generator().manual_seed(0)
    other = fn(torch.tensor(x0) * (1 + 1e-7 * torch.randn(3, 7, generator=gen)))
    for k in ("X", "U", "fuel_used"):
        d = np.abs(getattr(out, k).numpy() - np.asarray(getattr(ref, k))).max()
        spread = (getattr(out, k) - getattr(other, k)).abs().max().item()
        assert d <= max(1e-3, 2.0 * spread), (k, d, spread)
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))
