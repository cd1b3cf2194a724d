"""The port's QP layer (gpmpc_tpu_torch/ops/qp) against the JAX package on
the CPU: Ruiz scaling, the condensed builder, and the batched ADMM solve on
random QPs and the golden sparse-form fixtures."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.qp import admm as JA
from gpmpc_tpu.ops.qp import condensed as JC
from gpmpc_tpu.ops.qp import ruiz as JR
from gpmpc_tpu.ops.qp.mpc_qp import split_z as jax_split_z
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.ops.qp import QPData, admm as TA, condensed as TC, ruiz as TR
from gpmpc_tpu_torch.ops.qp import join_z, split_z

sys.path.insert(0, "tests")
from test_qp import random_qp  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qp_golden.npz")
SCENARIOS = ("canonical", "high_fast", "low_slow", "lateral")


def _stack(datas):
    return QPData(*[torch.tensor(np.stack([np.asarray(getattr(d, k)) for d in datas]))
                    for k in ("P", "q", "A", "l", "u")])


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_ruiz_matches_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    sd, sc = TR.ruiz_equilibrate(_stack(datas), 10)
    for b, d in enumerate(datas):
        jd, jsc = JR.ruiz_equilibrate(d, 10)
        # f32 products of a few scaling factors: a few ulps
        for k in ("P", "q", "A", "l", "u"):
            np.testing.assert_allclose(getattr(sd, k)[b].numpy(), getattr(jd, k),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sc.D[b].numpy(), jsc.D, rtol=1e-5)
        np.testing.assert_allclose(sc.E[b].numpy(), jsc.E, rtol=1e-5)
        np.testing.assert_allclose(sc.c[b].item(), float(jsc.c), rtol=1e-5)


def test_rho_vec_and_factor_match_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    td = _stack(datas)
    rv = TA._rho_vec(td.l, td.u, torch.full((3,), 0.1))
    Minv = TA._factor(td.P, td.A, rv, 1e-6)
    for b, d in enumerate(datas):
        jrv = JA._rho_vec(d.l, d.u, jnp.asarray(0.1))
        np.testing.assert_array_equal(rv[b].numpy(), jrv)
        jM = JA._factor(d.P, d.A, jrv, 1e-6)
        # two f32 Cholesky implementations: relative error of the inverse
        # ~ cond(M)·eps; 1e-4 of its largest entry
        np.testing.assert_allclose(Minv[b].numpy(), jM, atol=1e-4 * float(jnp.abs(jM).max()))


def test_factor_marks_indefinite_lanes_nan():
    P = torch.stack([torch.eye(3), -torch.eye(3)])
    A = torch.zeros(2, 1, 3)
    Minv = TA._factor(P, A, torch.ones(2, 1), 0.0)
    assert bool(torch.isfinite(Minv[0]).all())
    assert bool(torch.isnan(Minv[1]).all())


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_solve_matches_jax_off(mode, adaptive):
    datas = [random_qp(np.random.default_rng(s)) for s in range(4)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas="off", infeas_certs=False,
                         adaptive_rho=adaptive)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    ts = TA.solve(_stack(datas), config=tcfg)
    js = [JA.solve(d, config=jcfg) for d in datas]
    # f32 Cholesky/reduction order differs between the frameworks; over 100
    # iterations the iterates stay within 5e-4 (test_pallas.py's lanes-vs-off
    # bound for the full solve)
    np.testing.assert_allclose(ts.x.numpy(), np.stack([s.x for s in js]), atol=5e-4)
    np.testing.assert_allclose(ts.obj.numpy(), np.stack([s.obj for s in js]), rtol=1e-4, atol=1e-4)
    if not adaptive:
        # fixed ρ: no discrete ρ decisions to flip, so the schedule is identical
        np.testing.assert_array_equal(ts.status.numpy(), [int(s.status) for s in js])
        np.testing.assert_array_equal(ts.iterations.numpy(), [int(s.iterations) for s in js])


def test_solve_warm_start_and_rho0_match_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=(3, 12)).astype(np.float32)
    y0 = rng.normal(size=(3, 18)).astype(np.float32) * 0.1
    rho0 = np.array([0.05, 0.1, 0.3], np.float32)
    jcfg = JA.ADMMConfig(max_iter=50, check_interval=25, use_pallas="off",
                         infeas_certs=False, adaptive_rho=False, scaling=2)
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    ts = TA.solve(_stack(datas), torch.tensor(x0), torch.tensor(y0), tcfg,
                  rho0=torch.tensor(rho0))
    for b, d in enumerate(datas):
        js = JA.solve(d, jnp.asarray(x0[b]), jnp.asarray(y0[b]), jcfg, rho0=jnp.asarray(rho0[b]))
        np.testing.assert_allclose(ts.x[b].numpy(), js.x, atol=5e-4)
        np.testing.assert_allclose(ts.y[b].numpy(), js.y, atol=5e-3)
        assert int(ts.status[b]) == int(js.status)


def test_fixed_scaling_matches_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(2)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas="off", infeas_certs=False,
                         adaptive_rho=False)
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    td = _stack(datas)
    _, sc = TR.ruiz_equilibrate(td, 3)
    ts = TA.solve(td, config=tcfg, fixed_scaling=sc)
    for b, d in enumerate(datas):
        jsc = JR.Scaling(D=jnp.asarray(sc.D[b].numpy()), E=jnp.asarray(sc.E[b].numpy()),
                         c=jnp.asarray(sc.c[b].item()))
        js = JA.solve(d, config=jcfg, fixed_scaling=jsc)
        np.testing.assert_allclose(ts.x[b].numpy(), js.x, atol=5e-4)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_golden_fixtures_match_certified_optimum(mode):
    """The four sparse-form golden QPs (n=207, m=354) solved in one batch.
    Polish is not in this slice, and without it ADMM closes the gap to the
    certified optimum x_star slowly on this badly scaled QP (at 400
    iterations both packages still sit 0.026 off in u0, on the same row), so
    the budget is 1000 iterations. Both packages then land within 2e-3 of
    x_star's u0, and within 2e-3 of each other (f32 reordering over 1000
    iterations)."""
    fx = np.load(FIXTURE)
    data = QPData(*[torch.tensor(np.stack([fx[f"{s}/{p}"] for s in SCENARIOS]),
                                 dtype=torch.float32) for p in ("P", "q", "A", "l", "u")])
    cfg = TA.ADMMConfig(max_iter=1000, infeas_certs=False, use_pallas=mode)
    sol = TA.solve(data, config=cfg)
    _, U = split_z(sol.x, 20, 7, 3)
    for b, s in enumerate(SCENARIOS):
        jd = JA.QPData(*[jnp.asarray(fx[f"{s}/{p}"], jnp.float32) for p in ("P", "q", "A", "l", "u")])
        jsol = JA.solve(jd, config=JA.ADMMConfig(max_iter=1000, infeas_certs=False, use_pallas="off"))
        _, U_j = jax_split_z(jsol.x, 20, 7, 3)
        _, U_star = jax_split_z(jnp.asarray(fx[f"{s}/x_star"], jnp.float32), 20, 7, 3)
        assert float(sol.pri_res[b]) < 2e-3
        np.testing.assert_allclose(U[b, 0].numpy(), U_star[0], atol=2e-3)
        np.testing.assert_allclose(np.asarray(U_j[0]), U_star[0], atol=2e-3)
        np.testing.assert_allclose(U[b, 0].numpy(), U_j[0], atol=2e-3)


def test_chunk_guard_is_two_sided():
    data = _stack([random_qp(np.random.default_rng(0))])
    for mi, ci in ((80, 50), (20, 25)):
        cfg = TA.ADMMConfig(max_iter=mi, check_interval=ci, infeas_certs=False)
        with pytest.raises(ValueError, match="must be a multiple"):
            TA.solve(data, config=cfg)


@pytest.mark.parametrize("kw", [
    {"polish": True}, {"infeas_certs": True}, {"matvec_dtype": "bf16"},
    {"row_structure": (("blt", 2, 3, 6),)},
    {"row_structure": (("blockdiag", 2, 1, 6),)},
])
def test_features_outside_the_slice_raise(kw):
    data = _stack([random_qp(np.random.default_rng(0))])
    base = {"max_iter": 25, "infeas_certs": False}
    cfg = TA.ADMMConfig(**{**base, **kw})
    with pytest.raises(NotImplementedError):
        TA.solve(data, config=cfg)


def test_warm_kkt_raises():
    data = _stack([random_qp(np.random.default_rng(0))])
    cfg = TA.ADMMConfig(max_iter=25, infeas_certs=False)
    with pytest.raises(NotImplementedError, match="warm KKT"):
        TA.solve(data, config=cfg, kkt_inv0=torch.zeros(1, 12, 12))


def test_diag_structure_matches_dense():
    """The compacted 'diag' stream gives the dense stream's answer."""
    n = 12
    rng = np.random.default_rng(3)
    G = rng.normal(size=(2, n, n))
    P = torch.tensor(G @ G.transpose(0, 2, 1) + 0.1 * np.eye(n), dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(2, n)), dtype=torch.float32)
    A = torch.eye(n).expand(2, n, n).clone()
    data = QPData(P=P, q=q, A=A, l=-torch.ones(2, n), u=torch.ones(2, n))
    base = dict(max_iter=50, check_interval=25, infeas_certs=False, use_pallas="off")
    dense = TA.solve(data, config=TA.ADMMConfig(**base))
    diag = TA.solve(data, config=TA.ADMMConfig(**base, row_structure=(("diag", n),)))
    torch.testing.assert_close(diag.x, dense.x, rtol=0, atol=1e-5)


def test_condensed_qp_matches_jax():
    rng = np.random.default_rng(0)
    B, N, n_x, n_u = 3, 6, 7, 3
    Aks = (np.eye(n_x) + 0.05 * rng.normal(size=(B, N, n_x, n_x))).astype(np.float32)
    Bks = (0.1 * rng.normal(size=(B, N, n_x, n_u))).astype(np.float32)
    cks = (0.1 * rng.normal(size=(B, N, n_x))).astype(np.float32)
    x0 = rng.normal(size=(B, n_x)).astype(np.float32)
    Q = np.diag([0.0, 10, 10, 10, 1, 1, 1]).astype(np.float32)
    R = (np.eye(3) * 0.01).astype(np.float32)
    xr = rng.normal(size=(B, N + 1, n_x)).astype(np.float32)
    xmin = np.array([-1e20, -100, -100, -100, -50, -50, -50], np.float32)
    xmax = -xmin
    Ulo = (0.3 + 0.1 * rng.random(size=(B, N, n_u))).astype(np.float32)
    Uhi = Ulo + 4.0
    u = rng.normal(size=(B, N * n_u)).astype(np.float32)
    T = torch.tensor
    for mask in (None, (False,) * 7, (False, True, False, True, False, False, True)):
        td, tG, tds = TC.build_condensed_qp(
            T(Aks), T(Bks), T(cks), T(x0), T(Q), T(R), T(Q * 10), T(xr),
            T(xmin), T(xmax), T(Ulo), T(Uhi), x_bound_mask=mask)
        tX = TC.recover_states(tG, tds, T(u), T(x0))
        for b in range(B):
            jd, jG, jds = JC.build_condensed_qp(
                Aks[b], Bks[b], cks[b], x0[b], Q, R, Q * 10, xr[b], xmin, xmax,
                Ulo[b], Uhi[b], x_bound_mask=mask)
            for k in ("P", "q", "A", "l", "u"):
                ref = np.asarray(getattr(jd, k))
                # f32 matmul chains of a few stages; relative to the entry scale
                np.testing.assert_allclose(getattr(td, k)[b].numpy(), ref,
                                           rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref[np.abs(ref) < 1e19]).max()))
            np.testing.assert_allclose(tX[b].numpy(), JC.recover_states(jG, jds, u[b], x0[b]),
                                       rtol=1e-5, atol=1e-5)


def test_condensed_facets_raise():
    z = torch.zeros
    with pytest.raises(NotImplementedError):
        TC.build_condensed_qp(z(1, 2, 7, 7), z(1, 2, 7, 3), z(1, 2, 7), z(1, 7),
                              torch.eye(7), torch.eye(3), torch.eye(7), z(1, 3, 7),
                              z(7), z(7), z(3), z(3), Gu=torch.eye(3))


def test_join_split_roundtrip():
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(2, 5, 7)), dtype=torch.float32)
    U = torch.tensor(rng.normal(size=(2, 4, 3)), dtype=torch.float32)
    z = join_z(X, U)
    X2, U2 = split_z(z, 4, 7, 3)
    torch.testing.assert_close(X2, X)
    torch.testing.assert_close(U2, U)
    _, Uj = jax_split_z(jnp.asarray(z[0].numpy()), 4, 7, 3)
    np.testing.assert_array_equal(U[0].numpy(), Uj)
