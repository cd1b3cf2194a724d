"""The rest of the port's MPC layer against the JAX package on the CPU, on
the same NumPy inputs: the Riccati solvers (also against SciPy in float64),
the stage costs and the LQR terminal cost, the constraint evaluators and
tighteners, the unscented, Monte-Carlo and interval-tube propagators, and
the nominal MPC over five closed-loop cycles.

Tolerances: f32 algebra that both packages do in the same order is held at
a relative 1e-5; the Riccati recursions (25-30 solves, f32) at a relative
1e-4, and the float64 port against SciPy at 1e-4; the unscented transform
(a Cholesky a stage) at 1e-4; the nominal MPC's u0 at 2e-4 a cycle, as
``tests/test_torch_mpc.py`` holds the GP-MPC cycle. Monte-Carlo draws differ
between the packages' generators, so those are held to their moments."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxP3, rocket3dof as jr3
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig, RTIConfig as JaxRTIConfig
from gpmpc_tpu.mpc import constraints as JC, cost_functions as JCF, uncertainty_prop as JU
from gpmpc_tpu.mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
from gpmpc_tpu.ops import linalg as JLA
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr3
from gpmpc_tpu_torch.mpc import constraints as TC, cost_functions as TCF, uncertainty_prop as TU
from gpmpc_tpu_torch.mpc import (NominalMPC, NominalMPC3DoF, make_nominal_mpc_controller)
from gpmpc_tpu_torch.ops import linalg as TLA

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a, dtype=torch.float32: torch.tensor(np.asarray(a), dtype=dtype)
J = lambda a: jnp.asarray(np.asarray(a))
_JP, _TP = JaxP3(), Rocket3DoFParams(device="cpu")
jF = lambda x, u: jr3.step(_JP, x, u, DT)
tF = lambda x, u: tr3.step(_TP, x, u, DT)


def _systems():
    """Two (A, B, Q, R): a random 4-state discrete system, and the 3-DoF
    hover Jacobians with the backup's Q (1e-4 on the mass)."""
    rng = np.random.default_rng(0)
    A = (0.5 * rng.normal(size=(4, 4))).astype(np.float32)
    B = rng.normal(size=(4, 2)).astype(np.float32)
    x_eq = jnp.array([2.0, 5.0, 0, 0, 0, 0, 0])
    u_eq = -2.0 * _JP.g_I
    Ah = np.asarray(jax.jacfwd(lambda x: jF(x, u_eq))(x_eq))
    Bh = np.asarray(jax.jacfwd(lambda u: jF(x_eq, u))(u_eq))
    Qh = np.diag([1e-4, 10, 10, 10, 5, 5, 5]).astype(np.float32)
    return [(A, B, np.eye(4, dtype=np.float32), 0.5 * np.eye(2, dtype=np.float32)),
            (Ah, Bh, Qh, 0.1 * np.eye(3, dtype=np.float32))]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("which", [0, 1])
def test_discrete_riccati_matches_jax_and_scipy(which):
    A, B, Q, R = _systems()[which]
    P_t = TLA.solve_dare(T(A), T(B), T(Q), T(R))
    assert _rel(P_t, JLA.solve_dare(J(A), J(B), J(Q), J(R))) < 1e-4
    P64 = TLA.solve_dare(*(T(M, torch.float64) for M in (A, B, Q, R)))
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    assert _rel(P64, sl.solve_discrete_are(A64, B64, Q, R)) < 1e-4
    K_t, P_t = TLA.dlqr(T(A), T(B), T(Q), T(R))
    K_j, P_j = JLA.dlqr(J(A), J(B), J(Q), J(R))
    assert _rel(K_t, K_j) < 1e-4 and _rel(P_t, P_j) < 1e-4
    # a leading batch axis solves each system on its own
    Ab = torch.stack([T(A), 0.9 * T(A)])
    Kb, Pb = TLA.dlqr(Ab, T(B), T(Q), T(R))
    K1, P1 = TLA.dlqr(0.9 * T(A), T(B), T(Q), T(R))
    assert _rel(Kb[1], K1) < 1e-5 and _rel(Pb[0], P_t) < 1e-5


def test_continuous_riccati_matches_jax_and_scipy():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(4, 4)).astype(np.float32)
    B = rng.normal(size=(4, 2)).astype(np.float32)
    Q, R = np.eye(4, dtype=np.float32), 0.5 * np.eye(2, dtype=np.float32)
    P_t = TLA.solve_care(T(A), T(B), T(Q), T(R))
    assert _rel(P_t, JLA.solve_care(J(A), J(B), J(Q), J(R))) < 1e-4
    P64 = TLA.solve_care(*(T(M, torch.float64) for M in (A, B, Q, R)))
    assert _rel(P64, sl.solve_continuous_are(A.astype(np.float64), B.astype(np.float64),
                                             Q, R)) < 1e-4
    K_t, _ = TLA.clqr(T(A), T(B), T(Q), T(R))
    K_j, _ = JLA.clqr(J(A), J(B), J(Q), J(R))
    assert _rel(K_t, K_j) < 1e-4
    Kb, _ = TLA.clqr(torch.stack([T(A), T(A)]), T(B), T(Q), T(R))
    assert _rel(Kb[1], K_t) < 1e-5


def test_cost_functions_match_jax():
    rng = np.random.default_rng(2)
    B = 5
    x = rng.normal(size=(B, 7)).astype(np.float32)
    u = rng.normal(size=(B, 3)).astype(np.float32)
    xr = rng.normal(size=7).astype(np.float32)
    ur = rng.normal(size=3).astype(np.float32)
    w = JCF.CostWeights()
    Q, R, P = np.asarray(w.Q_3dof()), np.asarray(w.R()), np.asarray(w.P_3dof())
    vm = lambda f, *a: jax.vmap(f, in_axes=(0, 0) + (None,) * len(a))
    pairs = [
        (TCF.quadratic_stage_cost(T(x), T(u), T(xr), T(Q), T(R)),
         vm(JCF.quadratic_stage_cost, 1, 2, 3)(J(x), J(u), J(xr), J(Q), J(R))),
        (TCF.fuel_optimal_stage_cost(T(x), T(u), T(xr), T(Q), T(R), 0.3),
         vm(JCF.fuel_optimal_stage_cost, 1, 2, 3, 4)(J(x), J(u), J(xr), J(Q), J(R), 0.3)),
        (TCF.tracking_stage_cost(T(x), T(u), T(xr), T(ur), T(Q), T(R)),
         vm(JCF.tracking_stage_cost, 1, 2, 3, 4)(J(x), J(u), J(xr), J(ur), J(Q), J(R))),
        (TCF.terminal_cost(T(x), T(xr), T(P)),
         jax.vmap(JCF.terminal_cost, in_axes=(0, None, None))(J(x), J(xr), J(P))),
    ]
    X = rng.normal(size=(B, 9, 7)).astype(np.float32)
    U = rng.normal(size=(B, 8, 3)).astype(np.float32)
    pairs.append((TCF.trajectory_cost(T(X), T(U), T(xr), T(Q), T(R), T(P)),
                  jax.vmap(JCF.trajectory_cost, in_axes=(0, 0, None, None, None, None))(
                      J(X), J(U), J(xr), J(Q), J(R), J(P))))
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)

    # the LQR terminal cost at the hover equilibrium
    x_eq, u_eq = np.array([2.0, 5.0, 0, 0, 0, 0, 0], np.float32), np.array([2.0, 0, 0], np.float32)
    Qh = np.diag([1e-4, 10, 10, 10, 5, 5, 5]).astype(np.float32)
    Rh = 0.1 * np.eye(3, dtype=np.float32)
    jlin = lambda xx, uu: (jax.jacfwd(lambda a: jF(a, uu))(xx), jax.jacfwd(lambda b: jF(xx, b))(uu))
    tlin = lambda xx, uu: torch.func.jacfwd(tF, argnums=(0, 1))(xx, uu)
    jt = JCF.LQRTerminalCost.create(jlin, J(x_eq), J(u_eq), J(Qh), J(Rh))
    tt = TCF.LQRTerminalCost.create(tlin, T(x_eq), T(u_eq), T(Qh), T(Rh))
    assert _rel(tt.P, jt.P) < 1e-4 and _rel(tt.K, jt.K) < 1e-4
    xs = x_eq + 0.3 * rng.normal(size=(B, 7)).astype(np.float32)
    np.testing.assert_allclose(tt.value(T(xs)).numpy(), np.asarray(jax.vmap(jt.value)(J(xs))),
                               rtol=1e-4)
    np.testing.assert_allclose(tt.gradient(T(xs)).numpy(),
                               np.asarray(jax.vmap(jt.gradient)(J(xs))), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tt.control(T(xs), T(u_eq)).numpy(),
                               np.asarray(jax.vmap(lambda a: jt.control(a, J(u_eq)))(J(xs))),
                               rtol=1e-4, atol=1e-4)
    Kc, Pc = TCF.compute_lqr_gain(*(T(np.asarray(M)) for M in jlin(J(x_eq), J(u_eq))), T(Qh), T(Rh))
    assert _rel(Pc, jt.P) < 1e-4


def test_constraints_match_jax():
    rng = np.random.default_rng(3)
    B = 16
    x = np.zeros((B, 14), np.float32)
    x[:, 0] = 2.0
    x[:, 1] = rng.uniform(0.0, 10.0, B)
    x[:, 2:4] = rng.normal(0, 3.0, (B, 2))
    x[:, 4:7] = rng.normal(0, 20.0, (B, 3))
    q = rng.normal(size=(B, 4))
    x[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 11:14] = rng.normal(0, 1.0, (B, 3))
    u = rng.normal(size=(B, 3)).astype(np.float32) * 2.0
    u[:, 0] = np.abs(u[:, 0]) + 0.2
    jp = JC.ConstraintParams.from_degrees(delta_max=15.0, theta_max=30.0, T_min=0.3)
    tp = TC.ConstraintParams.from_degrees(delta_max=15.0, theta_max=30.0, T_min=0.3)
    assert dataclasses.asdict(tp) == pytest.approx(
        {f: getattr(jp, f) for f in jp.__dataclass_fields__})
    for tf, jf, xs in ((TC.check_all_constraints, JC.check_all_constraints, x),
                       (TC.check_constraints_3dof, JC.check_constraints_3dof, x[:, :7])):
        tr_, jr_ = tf(T(xs), T(u), tp), jf(J(xs), J(u), jp)
        assert set(tr_) == set(jr_)
        for k in tr_:
            np.testing.assert_allclose(tr_[k].numpy(), np.asarray(jr_[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    # tightening from covariances, box shrinking, AD Jacobians
    G = rng.normal(size=(B, 14, 14)).astype(np.float32)
    S = G @ G.transpose(0, 2, 1) * 0.01
    tt = TC.TightenedConstraints.from_covariances(T(S), 0.9)
    jt = JC.TightenedConstraints.from_covariances(J(S), 0.9)
    for f in ("glideslope_backoff", "velocity_backoff", "tilt_backoff", "omega_backoff"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), rtol=1e-5)
    lo, hi, bo = -np.ones(7, np.float32), np.ones(7, np.float32), np.linspace(0, 2, 7).astype(np.float32)
    for a, b in zip(TC.tighten_bounds(T(lo), T(hi), T(bo)), JC.tighten_bounds(J(lo), J(hi), J(bo))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b))
    jc = lambda xx, uu: jnp.stack([JC.eval_glideslope(xx[1:4], jp.gamma_gs),
                                  JC.eval_thrust_magnitude(uu) - jp.T_max])
    tcf = lambda xx, uu: torch.stack([TC.eval_glideslope(xx[1:4], tp.gamma_gs),
                                      TC.eval_thrust_magnitude(uu) - tp.T_max])
    Jx_t, Ju_t = TC.constraint_jacobians(tcf, T(x[:, :7]), T(u))
    Jx_j, Ju_j = jax.vmap(lambda a, b: JC.constraint_jacobians(jc, a, b))(J(x[:, :7]), J(u))
    np.testing.assert_allclose(Jx_t.numpy(), np.asarray(Jx_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Ju_t.numpy(), np.asarray(Ju_j), rtol=1e-5, atol=1e-6)
    Jx1, _ = TC.constraint_jacobians(tcf, T(x[0, :7]), T(u[0]))
    np.testing.assert_allclose(Jx1.numpy(), Jx_t[0].numpy())


def _plan(B=3, n_steps=6):
    rng = np.random.default_rng(4)
    x0 = np.tile(np.array([2.0, 20.0, 0.5, -0.3, -2.0, 0.1, 0.0], np.float32), (B, 1))
    x0[:, 1] += np.arange(B)
    U = np.tile(np.array([2.2, 0.05, -0.02], np.float32), (B, n_steps, 1))
    U += 0.05 * rng.normal(size=U.shape).astype(np.float32)
    return x0, U


def test_unscented_propagation_matches_jax():
    x0, U = _plan()
    S0 = np.diag([1e-4, 0.04, 0.04, 0.04, 0.01, 0.01, 0.01]).astype(np.float32)
    gv = np.full((x0.shape[0], U.shape[1], 3), 0.02, np.float32)
    t = TU.propagate_unscented(tF, T(x0), T(S0), T(U), T(gv), dt=DT)
    j = jax.vmap(lambda a, b, c: JU.propagate_unscented(jF, a, J(S0), b, c, dt=DT))(
        J(x0), J(U), J(gv))
    np.testing.assert_allclose(t.means.numpy(), np.asarray(j.means), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.covariances.numpy(), np.asarray(j.covariances), rtol=1e-4,
                               atol=1e-6)
    lo_t, hi_t = t.confidence_bounds(0.9)
    lo_j, hi_j = jax.vmap(lambda m, c: JU.PropagatedUncertainty(m, c).confidence_bounds(0.9))(
        j.means, j.covariances)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=1e-4, atol=1e-4)
    # the facade dispatches by name
    up = TU.UncertaintyPropagator("unscented", dt=DT)
    np.testing.assert_allclose(up.propagate(step_fn=tF, x0=T(x0), Sigma0=T(S0), U=T(U),
                                            gp_vars=T(gv)).means.numpy(), t.means.numpy())
    with pytest.raises(ValueError):
        TU.UncertaintyPropagator("nope").propagate()


def test_monte_carlo_propagation_moments():
    """Linear dynamics x⁺ = A x + B u: the particle mean follows the
    deterministic rollout and the particle covariance A Σ Aᵀ (+ noise), held
    at the sampling error of 4096 particles (10% on the variances)."""
    rng = np.random.default_rng(5)
    A = np.eye(3, dtype=np.float32) + 0.1 * rng.normal(size=(3, 3)).astype(np.float32)
    Bm = rng.normal(size=(3, 2)).astype(np.float32)
    step = lambda x, u: x @ T(A).T + u @ T(Bm).T
    x0 = np.array([[1.0, -1.0, 0.5], [0.0, 2.0, 1.0]], np.float32)
    U = rng.normal(size=(2, 4, 2)).astype(np.float32)
    S0 = np.diag([0.04, 0.01, 0.09]).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    noise = 0.05
    mc = TU.propagate_monte_carlo(gen, step, T(x0), T(S0), T(U), n_particles=4096,
                                  gp_std_fn=lambda p, u: noise * torch.ones_like(p))
    mu, S = x0.astype(np.float64), np.broadcast_to(S0, (2, 3, 3)).astype(np.float64)
    for k in range(4):
        mu = mu @ A.T + U[:, k] @ Bm.T
        S = A @ S @ A.T + noise**2 * np.eye(3)
    np.testing.assert_allclose(mc.means[:, -1].numpy(), mu, atol=0.03)
    np.testing.assert_allclose(np.diagonal(mc.covariances[:, -1].numpy(), axis1=1, axis2=2),
                               np.diagonal(S, axis1=1, axis2=2), rtol=0.1)


def test_tightening_and_tube_match_jax():
    rng = np.random.default_rng(6)
    G = rng.normal(size=(2, 5, 7, 7)).astype(np.float32)
    S = G @ G.transpose(0, 1, 3, 2) * 0.01
    a = rng.normal(size=7).astype(np.float32)
    np.testing.assert_allclose(
        TU.linear_tightening(T(a), T(S), 0.9).numpy(),
        np.asarray(jax.vmap(lambda s: JU.linear_tightening(J(a), s, 0.9))(J(S))), rtol=1e-5)
    # the sampled back-off against the Gaussian quantile κ·√(aᵀΣa)
    gen = torch.Generator().manual_seed(1)
    mean = rng.normal(size=(3, 7)).astype(np.float32)
    st = TU.sampled_tightening(gen, T(mean), T(S[0, :3]), T(a), 0.9, n_samples=20000)
    exact = TU.linear_tightening(T(a), T(S[0, :3]), 0.9)
    np.testing.assert_allclose(st.numpy(), exact.numpy(), rtol=0.05)
    # the interval tube
    Aks = (0.3 * rng.normal(size=(2, 6, 7, 7))).astype(np.float32)
    w = np.abs(rng.normal(size=7)).astype(np.float32) * 0.1
    e0 = np.abs(rng.normal(size=7)).astype(np.float32) * 0.01
    t = TU.propagate_tube(T(Aks), T(w), T(e0))
    j = jax.vmap(lambda A_: JU.propagate_tube(A_, J(w), J(e0)))(J(Aks))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(TU.TubeBasedRobustness(T(w)).propagate(T(Aks)).numpy(),
                               np.asarray(jax.vmap(lambda A_: JU.propagate_tube(A_, J(w)))(J(Aks))),
                               rtol=1e-5, atol=1e-7)


def _nominal_configs():
    jcfg = JaxGPMPCConfig(
        base=JaxRTIConfig(N=8, condensed=True, accept_pri_tol=5e-3,
                          admm=JaxADMMConfig(max_iter=100, polish=True, use_pallas="off")),
        scp_iterations=2, tighten=False)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["base"] = {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
                 for f in dataclasses.fields(jcfg.base) for v in [getattr(jcfg.base, f.name)]}
    d["base"]["admm"] = {f.name: getattr(jcfg.base.admm, f.name)
                         for f in dataclasses.fields(jcfg.base.admm)}
    return jcfg, convert.gp_mpc_config_from_fields(d, device="cpu")


def test_nominal_mpc_matches_jax():
    """Five closed-loop cycles of three lanes: the port's ``NominalMPC``
    against the JAX package's nominal solve (its ``gp_mpc_solve`` with the
    GP identically zero, as ``NominalMPC`` runs it), u0 within 2e-4."""
    jcfg, tcfg = _nominal_configs()
    x0 = np.tile(np.array([2.0, 10.0, 0.5, -0.4, -1.0, 0.1, 0.0], np.float32), (3, 1))
    x0[:, 1] += np.arange(3, dtype=np.float32)
    xT = np.array([2.0, 8.0, 0, 0, 0, 0, 0], np.float32)
    zm, zv = (lambda x, u: jnp.zeros(7)), (lambda x, u: jnp.zeros(3))
    step = jax.jit(jax.vmap(lambda s, x: jax_solve(jF, zm, zv, jcfg, s, x)))
    js = jax.vmap(lambda x: jax_init(jcfg, x, J(xT)))(J(x0))
    mpc = NominalMPC3DoF(tF, tcfg)
    assert isinstance(mpc, NominalMPC)
    with pytest.raises(ValueError):
        mpc.solve(T(x0))  # no target yet
    xj, xt = J(x0), T(x0)
    for k in range(5):
        sj, js = step(js, xj)
        st = mpc.solve(xt, T(xT) if k == 0 else None)
        np.testing.assert_allclose(st.u0.numpy(), np.asarray(sj.u0), atol=2e-4,
                                   err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        xj = jax.vmap(jF)(xj, sj.u0)
        xt = tF(xt, st.u0)
    # the closed loop and the Monte-Carlo adapter fly the same solves
    out = NominalMPC(tF, tcfg).simulate_closed_loop(T(x0), T(xT), 5)
    cinit, cstep = make_nominal_mpc_controller(tF, tcfg, T(xT))
    cs, x = cinit(T(x0)), T(x0)
    for k in range(5):
        u, cs = cstep(cs, x, k)
        np.testing.assert_allclose(out["U"][:, k].numpy(), u.numpy(), atol=1e-6)
        x = tF(x, u)
    assert out["X"].shape == (3, 6, 7) and not bool(out["landed"].any())
