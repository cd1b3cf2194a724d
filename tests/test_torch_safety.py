"""The port's safety layer (``gpmpc_tpu_torch/safety``) and episode learner
against the JAX package on the CPU, on the same NumPy inputs: the backup
controllers and invariant sets on ``tests/test_safety.py``'s ``setup``
values, the safety check and the filter on 64 lanes in soft and hard mode,
the gradient fallback, the filtered closed loop, the tube propagators, an
8-lane filtered RTI episode under the downdraft, the filtered campaign's
recovery policy, and two episodes of ``IterativeLearningRunner``.

Tolerances: V(x_N) relative 1e-5 (the same RK4 steps in f32); the filtered
u 1e-3 (100 ADMM iterations and a polish in f32); ``intervened`` equal lane
for lane outside 1e-4·α of the threshold (a lane that close to it is decided
by f32 rounding); Riccati products relative 1e-4; the tubes relative 1e-5.
Monte-Carlo draws differ between the packages' generators: those are held to
the Gaussian quantile they estimate.

The online safety composition (the filter reading each lane's learned GP) is
held against ``scripts/run_online_safety_tpu.py``'s own composition over two
episodes; its tolerances are set out in that test."""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import safety as JS
from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxP3, rocket3dof as jr3
from gpmpc_tpu.experiments.monte_carlo import SimulationConfig as JaxSim
from gpmpc_tpu.experiments.monte_carlo import run_campaign as jax_campaign
from gpmpc_tpu.learning import online_learner as JOL
from gpmpc_tpu.mpc import RTIConfig as JaxRTIConfig, make_rti_controller as jax_rti_ctrl
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.reference import cubic_descent_reference as jax_cubic
from gpmpc_tpu_torch import convert, safety as TS
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr3
from gpmpc_tpu_torch.experiments import SimulationConfig, run_campaign
from gpmpc_tpu_torch.learning import online_learner as TOL
from gpmpc_tpu_torch.mpc import RTIConfig, make_rti_controller
from gpmpc_tpu_torch.ops.qp import ADMMConfig
from gpmpc_tpu_torch.reference import cubic_descent_reference
from gpmpc_tpu_torch.safety.safety_filter import _value_and_grad
from test_torch_online import online_state_from_jax  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
J = lambda a: jnp.asarray(np.asarray(a))
_JP, _TP = JaxP3(), Rocket3DoFParams(device="cpu")
jF = lambda x, u: jr3.step(_JP, x, u, DT)
tF = lambda x, u: tr3.step(_TP, x, u, DT)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-30)


@pytest.fixture(scope="module")
def setup():
    """tests/test_safety.py::setup in both packages."""
    jp, tp = JaxP3(T_min=0.3, T_max=6.0), Rocket3DoFParams(T_min=0.3, T_max=6.0, device="cpu")
    jb, tb = JS.hover_backup_3dof(jp, altitude=5.0, dt=DT), TS.hover_backup_3dof(tp, altitude=5.0,
                                                                                   dt=DT)
    jinv = JS.compute_from_lqr(jb.P, jb.x_eq, alpha=50.0)
    tinv = TS.compute_from_lqr(tb.P, tb.x_eq, alpha=50.0)
    jcfg = JS.SafetyFilterConfig(N=10, dt=DT, u_min=jnp.array([0.3, -6.0, -6.0]),
                                 u_max=jnp.array([6.0, 6.0, 6.0]))
    tcfg = TS.SafetyFilterConfig(N=10, dt=DT, u_min=(0.3, -6.0, -6.0), u_max=(6.0, 6.0, 6.0),
                                 device="cpu")
    return dict(jb=jb, tb=tb, jinv=jinv, tinv=tinv, jcfg=jcfg, tcfg=tcfg,
                jstep=lambda x, u: jr3.step(jp, x, u, DT),
                tstep=lambda x, u: tr3.step(tp, x, u, DT))


def test_backup_controllers_match_jax(setup):
    jb, tb = setup["jb"], setup["tb"]
    assert _rel(tb.K, jb.K) < 1e-4 and _rel(tb.P, jb.P) < 1e-4
    rng = np.random.default_rng(0)
    xs = (np.asarray(jb.x_eq) + rng.normal(0, 1.0, (16, 7))).astype(np.float32)
    xs[:, 0] = 2.0
    np.testing.assert_allclose(tb.control(T(xs)).numpy(), np.asarray(jax.vmap(jb.control)(J(xs))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.lyapunov_value(T(xs)).numpy(),
                               np.asarray(jax.vmap(jb.lyapunov_value)(J(xs))), rtol=1e-4)
    # the backup rollout regulates hover (tests/test_safety.py) and matches
    x = np.asarray(jb.x_eq + jnp.array([0.0, 1.0, 0.5, -0.5, 0.5, 0.2, -0.1]))
    Xt = tb.rollout(setup["tstep"], T(x)[None], 60)[0]
    Xj = jb.rollout(setup["jstep"], J(x), 60)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-4)
    e0 = np.linalg.norm(Xt[0, 1:7] - tb.x_eq[1:7])
    assert float(np.linalg.norm(Xt[-1, 1:7] - tb.x_eq[1:7])) < 0.2 * float(e0)
    # the PD gain is selected where the Riccati recursion is not finite
    nan_lin = lambda x_, u_: (torch.full((7, 7), float("nan")), torch.zeros(7, 3))
    Q = torch.eye(7)
    fb = TS.LQRBackupController.create(nan_lin, tb.x_eq, tb.u_eq, Q, torch.eye(3), tb.u_min,
                                       tb.u_max)
    jfb = JS.LQRBackupController.create(lambda x_, u_: (jnp.full((7, 7), jnp.nan), jnp.zeros((7, 3))),
                                        jb.x_eq, jb.u_eq, jnp.eye(7), jnp.eye(3), jb.u_min, jb.u_max)
    np.testing.assert_array_equal(fb.K.numpy(), np.asarray(jfb.K))
    np.testing.assert_array_equal(fb.P.numpy(), Q.numpy())
    # PD hold and emergency braking, a lane at rest included
    pd_t = TS.create_backup_controller("pd", x_eq=tb.x_eq, u_eq=tb.u_eq, u_min=tb.u_min,
                                       u_max=tb.u_max)
    pd_j = JS.create_backup_controller("pd", x_eq=jb.x_eq, u_eq=jb.u_eq, u_min=jb.u_min,
                                       u_max=jb.u_max)
    np.testing.assert_allclose(pd_t.control(T(xs)).numpy(), np.asarray(jax.vmap(pd_j.control)(J(xs))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pd_t.lyapunov_value(T(xs)).numpy(),
                               np.asarray(jax.vmap(pd_j.lyapunov_value)(J(xs))), rtol=1e-5)
    xs[0, 4:7] = 0.0
    br_t = TS.create_backup_controller("braking", T_max=6.0, g_I=torch.tensor([-1.0, 0, 0]))
    br_j = JS.EmergencyBrakingController(T_max=6.0, g_I=jnp.array([-1.0, 0, 0]))
    u_br = br_t.control(T(xs))
    np.testing.assert_allclose(u_br.numpy(), np.asarray(jax.vmap(br_j.control)(J(xs))),
                               rtol=1e-5, atol=1e-5)
    assert float(torch.linalg.vector_norm(u_br, dim=1).max()) <= 6.0 + 1e-4
    with pytest.raises(ValueError):
        TS.create_backup_controller("nope")


def test_invariant_sets_match_jax(setup):
    jb, tb, jinv, tinv = setup["jb"], setup["tb"], setup["jinv"], setup["tinv"]
    rng = np.random.default_rng(1)
    xs = (np.asarray(jb.x_eq) + rng.normal(0, 2.0, (32, 7))).astype(np.float32)
    np.testing.assert_allclose(tinv.value(T(xs)).numpy(), np.asarray(jax.vmap(jinv.value)(J(xs))),
                               rtol=1e-4)
    np.testing.assert_array_equal(tinv.contains(T(xs)).numpy(),
                                  np.asarray(jax.vmap(jinv.contains)(J(xs))))
    far = tb.x_eq + 100.0 * torch.ones(7)
    assert bool(tinv.contains(tb.x_eq)) and not bool(tinv.contains(far))
    np.testing.assert_allclose(tinv.value(tinv.project(far[None])).item(), 50.0, rtol=1e-3)
    np.testing.assert_allclose(tinv.project(T(xs)).numpy(), np.asarray(jax.vmap(jinv.project)(J(xs))),
                               rtol=1e-4, atol=1e-4)
    pts = tinv.sample_boundary(torch.Generator().manual_seed(0), 64)
    np.testing.assert_allclose(tinv.value(pts).numpy(), 50.0, rtol=1e-3)
    # maximal α under |x1 − 5| ≤ 3: the bisection's α is at least the exact
    # 9/(P⁻¹)₁₁ (sampled directions can only overestimate) and its boundary
    # samples satisfy the constraint, as tests/test_safety.py asks
    cfn = lambda x: (x[..., 1] - 5.0).abs() - 3.0
    alpha = TS.compute_maximal_alpha(tb.P, tb.x_eq, cfn, torch.Generator().manual_seed(0),
                                     n_samples=128)
    exact = 9.0 / float(torch.linalg.inv(tb.P.double())[1, 1])
    assert exact * (1 - 1e-4) <= float(alpha) < 1e3
    inv = TS.EllipsoidalInvariantSet(P=tb.P, x_eq=tb.x_eq, alpha=alpha)
    assert float(cfn(inv.sample_boundary(torch.Generator().manual_seed(1), 128)).max()) <= 1e-2
    # the funnel (tests/test_safety.py::TestDescentFunnel) and its value
    fun_t, fun_j = TS.DescentFunnelSet(slope=0.6, v_free=1.5), JS.DescentFunnelSet(0.6, 1.5)
    e4 = torch.zeros(7)
    assert bool(fun_t.contains(e4 + torch.eye(7)[4] * -1.49))
    fast = e4 + torch.eye(7)[4] * -1.6
    assert not bool(fun_t.contains(fast)) and bool(fun_t.contains(fast + 10.0 * torch.eye(7)[1]))
    assert not bool(fun_t.contains(fast - 5.0 * torch.eye(7)[1]))
    np.testing.assert_allclose(fun_t.value(T(xs)).numpy(), np.asarray(fun_j.value(J(xs))),
                               rtol=1e-6)
    # tube controller, polytope, Lyapunov-equation matrix
    A = np.asarray(jax.jacfwd(lambda x: jF(x, -2.0 * _JP.g_I))(jnp.asarray(jb.x_eq)))
    Bm = np.asarray(jax.jacfwd(lambda u: jF(jnp.asarray(jb.x_eq), u))(-2.0 * _JP.g_I))
    w = np.full(7, 0.01, np.float32)
    tc_t = TS.TubeController.create(T(A), T(Bm), tb.K, T(w))
    tc_j = JS.TubeController.create(J(A), J(Bm), jb.K, J(w))
    assert _rel(tc_t.e_rpi, tc_j.e_rpi) < 1e-4
    np.testing.assert_allclose(
        tc_t.ancillary_control(T(xs), tb.x_eq, tb.u_eq).numpy(),
        np.asarray(jax.vmap(lambda x: tc_j.ancillary_control(x, jb.x_eq, jb.u_eq))(J(xs))),
        rtol=1e-4, atol=1e-4)
    H = rng.normal(size=(5, 7)).astype(np.float32)
    h = np.abs(rng.normal(size=5)).astype(np.float32) * 5.0
    pt, pj = TS.PolytopeInvariantSet(T(H), T(h)), JS.PolytopeInvariantSet(J(H), J(h))
    np.testing.assert_array_equal(pt.contains(T(xs)).numpy(), np.asarray(jax.vmap(pj.contains)(J(xs))))
    np.testing.assert_allclose(pt.margin(T(xs)).numpy(), np.asarray(jax.vmap(pj.margin)(J(xs))),
                               rtol=1e-5, atol=1e-5)
    A_cl = np.asarray(J(A) - J(Bm) @ jb.K)
    assert _rel(TS.compute_lmi_invariant_set(T(A_cl)), JS.compute_lmi_invariant_set(J(A_cl))) < 1e-4


def _funnel_lanes(B=64, seed=0):
    """Lanes under the downdraft's altitudes, some inside the funnel and some
    not, and their nominal controls; lane 0 at rest (v = 0)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 7), np.float32)
    x[:, 0] = 2.0
    x[:, 1] = rng.uniform(0.5, 8.0, B)
    x[:, 2:4] = rng.normal(0, 0.5, (B, 2))
    x[:, 4] = rng.uniform(-4.0, -0.5, B)
    x[:, 5:7] = rng.normal(0, 0.3, (B, 2))
    x[0, 4:7] = 0.0
    u = np.zeros((B, 3), np.float32)
    u[:, 0] = rng.uniform(0.5, 3.0, B)
    u[:, 1:] = rng.normal(0, 0.3, (B, 2))
    return x, u


def _funnel_filters(soft):
    T_max = _JP.T_max
    jcfg = JS.SafetyFilterConfig(N=5, dt=DT, u_min=jnp.array([0.0, -T_max, -T_max]),
                                 u_max=jnp.full(3, T_max), soft=soft)
    tcfg = TS.SafetyFilterConfig(N=5, dt=DT, u_min=(0.0, -T_max, -T_max), u_max=(T_max,) * 3,
                                 soft=soft, device="cpu")
    jb = JS.EmergencyBrakingController(T_max=T_max, g_I=jnp.array([-1.0, 0, 0]))
    tb = TS.EmergencyBrakingController(T_max=T_max, g_I=torch.tensor([-1.0, 0, 0]))
    return (JS.DescentFunnelSet(0.6, 1.5), jb, jcfg), (TS.DescentFunnelSet(0.6, 1.5), tb, tcfg)


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_check_safety_and_filter_match_jax(soft):
    x, u = _funnel_lanes()
    (jinv, jb, jcfg), (tinv, tb, tcfg) = _funnel_filters(soft)
    safe_t, V_t = TS.check_safety(tF, tb, tinv, tcfg, T(x), T(u))
    safe_j, V_j = jax.vmap(lambda a, b: JS.check_safety(jF, jb, jinv, jcfg, a, b))(J(x), J(u))
    V_j = np.asarray(V_j)
    assert _rel(V_t, V_j) < 1e-5
    clear = np.abs(V_j - tinv.alpha) > 1e-4 * tinv.alpha
    assert 10 < int(clear.sum()) and 0 < int((~np.asarray(safe_j)).sum()) < 60
    np.testing.assert_array_equal(safe_t.numpy()[clear], np.asarray(safe_j)[clear])
    rt = TS.filter_control(tF, tb, tinv, tcfg, T(x), T(u))
    rj = jax.vmap(lambda a, b: JS.filter_control(jF, jb, jinv, jcfg, a, b))(J(x), J(u))
    np.testing.assert_array_equal(rt.intervened.numpy()[clear], np.asarray(rj.intervened)[clear])
    np.testing.assert_array_equal(rt.qp_success.numpy()[clear], np.asarray(rj.qp_success)[clear])
    np.testing.assert_allclose(rt.u.numpy()[clear], np.asarray(rj.u)[clear], atol=1e-3)
    assert _rel(rt.lyapunov_value, rj.lyapunov_value) < 1e-5
    # a constraint makes every lane that violates it unsafe
    cons = lambda xx, uu: (xx[:, 1] - 4.0)[:, None]
    safe_c, _ = TS.check_safety(tF, tb, tinv, tcfg, T(x), T(u), constraint_fn=cons)
    np.testing.assert_array_equal(safe_c.numpy(), safe_t.numpy() & (x[:, 1] <= 4.0))


def test_zero_velocity_lane_has_a_finite_gradient():
    """A lane at rest (and a frozen landed lane) takes ‖v‖ = 0 into the
    braking law: its gradient of V(x_N(u)) is finite, and the rest of the
    batch is unaffected."""
    x, u = _funnel_lanes(8)
    x[1, 1], x[1, 4:7] = 0.05, 0.0  # landed and frozen
    (_, _, _), (tinv, tb, tcfg) = _funnel_filters(True)
    V, g = _value_and_grad(tF, tb, tinv, tcfg.N, T(x), T(u))
    assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(V).all())
    _, g_rest = _value_and_grad(tF, tb, tinv, tcfg.N, T(x[2:]), T(u[2:]))
    np.testing.assert_allclose(g[2:].numpy(), g_rest.numpy(), rtol=1e-6, atol=1e-7)
    jg = jax.vmap(jax.grad(lambda uu, xx: JS.DescentFunnelSet(0.6, 1.5).value(
        JS.safety_filter._backup_rollout_terminal(
            jF, JS.EmergencyBrakingController(T_max=_JP.T_max, g_I=jnp.array([-1.0, 0, 0])),
            xx, uu, tcfg.N))))(J(u), J(x))
    np.testing.assert_allclose(g[2:].numpy(), np.asarray(jg)[2:], rtol=1e-4, atol=1e-4)


def test_gradient_fallback_and_lqr_filter_match_jax(setup):
    """tests/test_safety.py's intervention cases (N = 2, α inside the window
    where an intervention is both needed and feasible) through the QP filter
    and the gradient fallback."""
    jb, tb, jcfg, tcfg = setup["jb"], setup["tb"], setup["jcfg"].replace(N=2), setup["tcfg"].replace(N=2)
    jstep, tstep = setup["jstep"], setup["tstep"]
    x = np.asarray(jb.x_eq + jnp.array([0.0, 0.5, 0.0, 0.0, -0.5, 0.0, 0.0]))
    u_bad = np.array([0.3, 6.0, -6.0], np.float32)
    _, V_backup = JS.check_safety(jstep, jb, setup["jinv"], jcfg, J(x), jb.control(J(x)))
    _, V_bad = JS.check_safety(jstep, jb, setup["jinv"], jcfg, J(x), J(u_bad))
    a = 0.5 * (V_backup / jcfg.alpha_margin + V_bad)
    jinv = setup["jinv"].replace(alpha=a)
    tinv = setup["tinv"].replace(alpha=torch.tensor(float(a)))
    rt = TS.filter_control(tstep, tb, tinv, tcfg, T(x)[None], T(u_bad)[None])
    rj = JS.filter_control(jstep, jb, jinv, jcfg, J(x), J(u_bad))
    assert bool(rt.intervened[0]) and bool(rj.intervened)
    np.testing.assert_allclose(rt.u[0].numpy(), np.asarray(rj.u), atol=1e-3)
    _, V_f = TS.check_safety(tstep, tb, tinv, tcfg, T(x)[None], rt.u)
    assert float(V_f[0]) < float(V_bad)
    gt = TS.filter_gradient(tstep, tb, tinv, tcfg, T(x)[None], T(u_bad)[None], steps=60)
    gj = JS.filter_gradient(jstep, jb, jinv, jcfg, J(x), J(u_bad), steps=60)
    np.testing.assert_allclose(gt.u[0].numpy(), np.asarray(gj.u), atol=1e-3)
    _, V_g = TS.check_safety(tstep, tb, tinv, tcfg, T(x)[None], gt.u)
    assert float(V_g[0]) < float(V_bad)
    # the magnitude clamp
    sf = TS.SimpleSafetyFilter(u_min=torch.tensor([0.3, -5.0, -5.0]), u_max=torch.full((3,), 5.0))
    res = sf.filter(torch.zeros(2, 7), torch.tensor([[10.0, 0, 0], [1.0, 0, 0]]))
    np.testing.assert_allclose(res.u.numpy(), [[5.0, 0, 0], [1.0, 0, 0]])
    assert res.intervened.tolist() == [True, False]


def test_simulate_filtered_matches_jax(setup):
    """tests/test_safety.py's filtered closed loop under a constant lateral
    push, two lanes, 30 steps: the same interventions step for step and the
    state within 1e-3."""
    jb, tb = setup["jb"], setup["tb"]
    x0 = np.stack([np.asarray(jb.x_eq + jnp.array([0.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0])),
                   np.asarray(jb.x_eq + jnp.array([0.0, -0.5, 0.0, 0.3, 0.2, 0.0, 0.0]))])
    push = np.array([2.0, 4.0, 0.0], np.float32)
    out_t = TS.simulate_filtered(setup["tstep"], tb, setup["tinv"], setup["tcfg"],
                                 lambda x, k: T(push).expand(x.shape[0], 3), T(x0), 30)
    out_j = jax.vmap(lambda x: JS.simulate_filtered(setup["jstep"], jb, setup["jinv"],
                                                    setup["jcfg"], lambda xx, k: J(push), x, 30))(
        J(x0))
    assert int(out_t["n_interventions"].sum()) > 0
    np.testing.assert_array_equal(out_t["interventions"].numpy(), np.asarray(out_j["interventions"]))
    np.testing.assert_allclose(out_t["X"].numpy(), np.asarray(out_j["X"]), atol=1e-3)
    assert float(out_t["X"][:, :, 2].abs().max()) < 20.0


def test_tube_propagators_match_jax():
    rng = np.random.default_rng(2)
    A = np.tile(0.9 * np.eye(7, dtype=np.float32), (10, 1, 1))
    A += (0.05 * rng.normal(size=A.shape)).astype(np.float32)
    w = np.abs(rng.normal(size=7)).astype(np.float32) * 0.01
    gv = np.abs(rng.normal(size=(10, 3))).astype(np.float32) * 0.04
    tp_t, tp_j = TS.TubePropagator(), JS.TubePropagator()
    np.testing.assert_allclose(tp_t.propagate(T(A), T(w)).numpy(),
                               np.asarray(tp_j.propagate(J(A), J(w))), rtol=1e-5, atol=1e-8)
    e_t = tp_t.propagate_gp(T(A), T(gv))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(tp_j.propagate_gp(J(A), J(gv))),
                               rtol=1e-5, atol=1e-8)
    assert e_t.shape == (11, 7) and float(e_t[0].max()) == 0.0
    # a lane axis ahead of the horizon: each lane its own tube
    Ab = torch.stack([T(A), 0.5 * T(A)])
    eb = tp_t.propagate_gp(Ab, T(gv).expand(2, 10, 3))
    np.testing.assert_allclose(eb[0].numpy(), e_t.numpy(), rtol=1e-6)
    # tighteners and the facade
    K = rng.normal(size=(3, 7)).astype(np.float32)
    e = np.asarray(e_t[-1])
    tt, tj = TS.TubeConstraintTightener(T(K)), JS.TubeConstraintTightener(J(K))
    lo, hi = -np.ones(7, np.float32), np.ones(7, np.float32)
    for a, b in zip(tt.tighten_box(T(lo), T(hi), T(e)), tj.tighten_box(J(lo), J(hi), J(e))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(tt.tighten_thrust(0.3, 5.0, T(e)), tj.tighten_thrust(0.3, 5.0, J(e))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    np.testing.assert_allclose(float(tt.tighten_glideslope(0.5, T(e[1:4]))),
                               float(tj.tighten_glideslope(0.5, J(e[1:4]))), rtol=1e-6)
    np.testing.assert_allclose(float(tt.tighten_tilt(0.5, T(e[:4]))),
                               float(tj.tighten_tilt(0.5, J(e[:4]))), rtol=1e-6)
    rm_t, rm_j = TS.RobustTubeMPC(T(K)), JS.RobustTubeMPC(J(K))
    xs = rng.normal(size=(4, 7)).astype(np.float32)
    u_lo, u_hi = np.array([0.3, -5, -5], np.float32), np.full(3, 5.0, np.float32)
    np.testing.assert_allclose(
        rm_t.ancillary_control(T(xs), torch.zeros(7), T(u_hi) * 0.4, T(u_lo), T(u_hi)).numpy(),
        np.asarray(jax.vmap(lambda x: rm_j.ancillary_control(x, jnp.zeros(7), J(u_hi) * 0.4,
                                                              J(u_lo), J(u_hi)))(J(xs))),
        rtol=1e-5, atol=1e-6)
    for a, b in zip(rm_t.tightened_bounds(T(A), T(w), T(lo), T(hi)),
                    rm_j.tightened_bounds(J(A), J(w), J(lo), J(hi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    # the Monte-Carlo tube: one step of noise σ from the nominal state has
    # width q_0.95(|σz|) = 1.96σ (4096 particles: 5%)
    p = Rocket3DoFParams(device="cpu")
    x0 = T([2.0, 20.0, 0, 0, -2.0, 0, 0])
    U = T([[2.0, 0.0, 0.0]] * 3)
    X_nom = torch.stack([x0, tF(x0, U[0])])
    for k in (1, 2):
        X_nom = torch.cat([X_nom, tF(X_nom[-1], U[k])[None]])
    noise = torch.full((7,), 0.01)
    widths = tp_t.propagate_monte_carlo(torch.Generator().manual_seed(0),
                                        lambda x, u: tr3.step(p, x, u, DT), X_nom, U, noise,
                                        n_particles=4096)
    assert widths.shape == (4, 7) and bool((widths[1:] > 0).all())
    np.testing.assert_allclose(widths[1].numpy(), 1.96 * 0.01, rtol=0.05)


def _rti_configs(N=10):
    admm = dict(max_iter=50, polish=False, adaptive_rho=False, scaling=3)
    jcfg = JaxRTIConfig(N=N, accept_pri_tol=5e-3, condensed=True,
                        admm=JaxADMMConfig(use_pallas="off", **admm))
    tcfg = RTIConfig(N=N, accept_pri_tol=5e-3, condensed=True, admm=ADMMConfig(**admm),
                     device="cpu")
    return jcfg, tcfg


def _gust_models(gust=-2.0):
    jg = lambda x: gust * jax.nn.sigmoid(6.0 - x[1])
    tg = lambda x: gust * torch.sigmoid(6.0 - x[:, 1])
    jpad = lambda x, u: jF(x, u) + DT * jnp.zeros(7).at[4].set(jg(x))
    tpad = lambda x, u: tF(x, u) + DT * tg(x)[:, None] * torch.eye(7)[4]
    return jpad, tpad


def _jax_to_port_rti(jstate):
    """The JAX filtered RTI controller's lane-batched state, carried into
    the port's."""
    (rti, xref), n_int, n_early, consec, switched = jstate
    st = convert.rti_state_from_numpy({f: np.asarray(getattr(rti, f)) for f in
                                       ("X_lin", "U_lin", "X_prev", "U_prev", "y_prev", "rho",
                                        "x_ref")}, device="cpu")
    return ((st, T(xref)),) + tuple(torch.tensor(np.asarray(a)) for a in
                                    (n_int, n_early, consec, switched))


def test_filtered_rti_episode_matches_jax():
    """Eight lanes of the rescue composition (condensed RTI at N = 10 behind
    the funnel filter with the downdraft-padded model) fly 30 steps into the
    downdraft. Teacher forced (the port gets the JAX state and controller
    state every step): u within 1e-3 and the same interventions. Flown
    apart: the same interventions and outcomes lane for lane; the states
    drift apart only as fast as the RTI controller's unconverged 50
    iterations amplify f32 differences (up to ~1e-3 by the end). The states
    keep every lane's V(x_N) clear of the threshold."""
    jcfg, tcfg = _rti_configs()
    xT = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)
    x0 = np.tile(np.array([2.0, 7.0, 0.2, -0.1, -2.0, 0.05, 0.0], np.float32), (8, 1))
    x0[:, 1] += np.linspace(0.0, 3.5, 8, dtype=np.float32)
    x0[:, 4] -= np.linspace(0.0, 1.4, 8, dtype=np.float32)
    jpad, tpad = _gust_models()
    (jinv, jb, jf), (tinv, tb, tf) = _funnel_filters(True)
    jc = jax_rti_ctrl(jF, jcfg, J(xT), reference_fn=lambda x: jax_cubic(x, J(xT), 30, DT),
                      ref_horizon=30)
    tc = make_rti_controller(tF, tcfg, T(xT),
                             reference_fn=lambda x: cubic_descent_reference(x, T(xT), 30, DT),
                             ref_horizon=30)
    jfi, jfs = JS.make_filtered_controller(*jc, jpad, jb, jinv, jf, half_step=15)
    tfi, tfs = TS.make_filtered_controller(*tc, tpad, tb, tinv, tf, half_step=15)
    jstep = jax.jit(jax.vmap(jfs, in_axes=(0, 0, None)))
    js, ts = jax.vmap(jfi)(J(x0)), tfi(T(x0))
    xj, xt = J(x0), T(x0)
    frozen = lambda x: x[:, 1] <= 0.1
    for k in range(30):
        ut_f, _ = tfs(_jax_to_port_rti(js), T(xj), k)  # teacher forced
        uj, js = jstep(js, xj, k)
        ut, ts = tfs(ts, xt, k)
        np.testing.assert_allclose(ut_f.numpy(), np.asarray(uj), atol=1e-3, err_msg=f"step {k}")
        np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]), err_msg=f"step {k}")
        xj = jnp.where(frozen(xj)[:, None], xj, jax.vmap(jpad)(xj, uj))
        xt = torch.where(frozen(xt)[:, None], xt, tpad(xt, ut))
    assert int(np.asarray(js[1]).sum()) > 0  # the filter fired
    np.testing.assert_array_equal(ts[2].numpy(), np.asarray(js[2]))
    landed = np.asarray(frozen(xj))
    np.testing.assert_array_equal(frozen(xt).numpy(), landed)
    speed_j = np.linalg.norm(np.asarray(xj)[:, 4:7], axis=1)
    speed_t = torch.linalg.vector_norm(xt[:, 4:7], dim=1).numpy()
    np.testing.assert_array_equal(landed & (speed_t <= 2.0), landed & (speed_j <= 2.0))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-2)
    info = TS.filtered_controller_info(ts)
    assert set(info) == {"n_interventions", "n_interventions_early", "switched_to_backup"}


def test_filtered_campaign_recovery_policy_matches_jax():
    """tests/test_safety.py's campaign: a controller that under-thrusts, the
    velocity-envelope filter (N = 3) over braking, 16 lanes, with and without
    the switch to the backup after 3 interventions in a row: the same
    outcomes, intervention counts and switches lane for lane."""
    from gpmpc_tpu.experiments.monte_carlo import sample_initial_conditions as jax_sample

    sim_j = JaxSim(max_steps=150, altitude_mean=10.0, altitude_std=1.0, horizontal_std=0.2,
                   horizontal_velocity_std=0.05)
    sim_t = SimulationConfig(max_steps=150, altitude_mean=10.0, altitude_std=1.0,
                             horizontal_std=0.2, horizontal_velocity_std=0.05)
    x0s = np.asarray(jax_sample(jax.random.PRNGKey(3), sim_j, 16))
    P = np.diag([0, 0, 0, 0, 1.0, 1.0, 1.0]).astype(np.float32)
    x_eq = np.array([0, 0, 0, 0, -0.8, 0, 0], np.float32)
    jinv = JS.EllipsoidalInvariantSet(P=J(P), x_eq=J(x_eq), alpha=0.05)
    tinv = TS.EllipsoidalInvariantSet(P=T(P), x_eq=T(x_eq), alpha=torch.tensor(0.05))
    (_, jb, _), (_, tb, _) = _funnel_filters(True)
    T_max = _JP.T_max
    jf = JS.SafetyFilterConfig(N=3, dt=DT, u_min=jnp.array([0.0, -T_max, -T_max]),
                               u_max=jnp.full(3, T_max))
    tf = TS.SafetyFilterConfig(N=3, dt=DT, u_min=(0.0, -T_max, -T_max), u_max=(T_max,) * 3,
                               device="cpu")
    bad_j = (lambda x0: jnp.zeros(0), lambda cs, x, k: (jnp.array([1.0, 0.0, 0.0]), cs))
    bad_t = (lambda x0: (), lambda cs, x, k: (torch.tensor([[1.0, 0, 0]]).expand(x.shape[0], 3), cs))
    for policy in ("continue", "switch_to_backup"):
        fi_j, fs_j = JS.make_filtered_controller(*bad_j, jF, jb, jinv,
                                                 jf.replace(max_consecutive=3, after_max=policy))
        fi_t, fs_t = TS.make_filtered_controller(*bad_t, tF, tb, tinv,
                                                 tf.replace(max_consecutive=3, after_max=policy))
        rj = jax.jit(lambda xs: jax_campaign(fi_j, fs_j, jF, xs, sim_j,
                                             cstate_info=JS.filtered_controller_info))(J(x0s))
        rt = run_campaign(fi_t, fs_t, tF, T(x0s), sim_t, cstate_info=TS.filtered_controller_info)
        np.testing.assert_array_equal(rt["outcome"].numpy(), np.asarray(rj["outcome"]))
        np.testing.assert_array_equal(rt["switched_to_backup"].numpy(),
                                      np.asarray(rj["switched_to_backup"]))
        assert (rt["n_interventions"].numpy() > 0).all()
        np.testing.assert_allclose(rt["n_interventions"].numpy(), np.asarray(rj["n_interventions"]),
                                   atol=1)
    with pytest.raises(ValueError):
        TS.make_filtered_controller(*bad_t, tF, tb, tinv, tf.replace(after_max="nope"))


def _pd_factory(jax_side):
    """A controller factory that flies the PD descent law (tests/test_lmpc.py's
    seed law), whatever the learner holds."""
    if jax_side:
        def step(cs, x, k):
            v_ref = -0.7 * jnp.sqrt(jnp.maximum(x[1], 0.0))
            u = jr3.hover_thrust(_JP, x) + jnp.array(
                [2.0 * (v_ref - x[4]), -1.0 * x[5] - 0.4 * x[2], -1.0 * x[6] - 0.4 * x[3]])
            return jr3.clamp_thrust(_JP.replace(T_min=0.3, T_max=5.0), u), cs
        return lambda learner: (lambda x0: jnp.zeros(0), step)

    def tstep(cs, x, k):
        v_ref = -0.7 * torch.sqrt(x[:, 1].clamp_min(0.0))
        u = tr3.hover_thrust(_TP, x) + torch.stack(
            [2.0 * (v_ref - x[:, 4]), -1.0 * x[:, 5] - 0.4 * x[:, 2],
             -1.0 * x[:, 6] - 0.4 * x[:, 3]], dim=-1)
        return tr3.clamp_thrust(_TP.replace(T_min=0.3, T_max=5.0), u), cs
    return lambda learner: (lambda x0: (), tstep)


def test_iterative_learning_runner_two_episodes(tmp_path):
    """Two episodes of the closed loop PD law → funnel filter → gusted plant
    → record in both packages: the same outcomes, costs, recorded
    transitions and statistics; the refitted GP predicts its own data; the
    retune runs on its cadence; ``save``/``load`` round-trip the store."""
    jpad, tpad = _gust_models(-1.0)
    (jinv, jb, jf), (tinv, tb, tf) = _funnel_filters(True)
    jsf = lambda x, u: JS.filter_control(jF, jb, jinv, jf, x, u).u
    tsf = lambda x, u: TS.filter_control(tF, tb, tinv, tf, x, u).u
    from gpmpc_tpu.learning import HyperparameterConfig as JH
    from gpmpc_tpu_torch.learning import HyperparameterConfig as TH
    jcfg = JOL.OnlineLearningConfig(hyper=JH(steps=10, retrain_every_episodes=2))
    tcfg = TOL.OnlineLearningConfig(hyper=TH(steps=10, retrain_every_episodes=2))
    jl, tl = JOL.OnlineLearner(jF, jcfg), TOL.OnlineLearner(tF, tcfg, device="cpu")
    jr = JOL.IterativeLearningRunner(jl, jpad, _pd_factory(True), safety_filter=jsf, max_steps=80)
    tr = TOL.IterativeLearningRunner(tl, tpad, _pd_factory(False), safety_filter=tsf, max_steps=80)
    x0s = np.array([[2.0, 7.0, 0.3, -0.2, -2.0, 0.1, 0.0], [2.0, 6.0, -0.2, 0.1, -1.5, 0.0, 0.1]],
                   np.float32)
    assert not tl.gp_active()
    out_j = [jr.run_episode(J(x)) for x in x0s]
    out_t = tr.run(T(x0s))
    for a, b in zip(out_t, out_j):
        assert (a["landed"], a["success"]) == (b["landed"], b["success"])
        np.testing.assert_allclose(a["cost"], b["cost"], rtol=1e-4)
        np.testing.assert_allclose(a["touchdown_speed"], b["touchdown_speed"], atol=1e-3)
    st_t, st_j = tl.get_statistics(), jl.get_statistics()
    for k in ("episodes", "successes", "success_rate", "gp_refits", "hyper_retunes",
              "buffer_count"):
        assert st_t[k] == st_j[k], k
    np.testing.assert_allclose(st_t["episode_costs"], st_j["episode_costs"], rtol=1e-4)
    n = st_t["buffer_count"]
    sj, stt = jl.data.store, tl.data.store
    for f in ("X", "U", "R"):
        np.testing.assert_allclose(getattr(stt, f)[:n].numpy(), np.asarray(getattr(sj, f))[:n],
                                   atol=1e-3, err_msg=f)
    np.testing.assert_array_equal(stt.success[:n].numpy(), np.asarray(sj.success)[:n])
    assert st_t["hyper_retunes"] == 1 and tl.gp_active()
    m, _ = tl.gp.predict(stt.X[:n], stt.U[:n])
    assert float((m - stt.R[:n]).abs().mean()) < 0.5 * float(stt.R[:n].abs().mean())
    r_mean, r_var = tl.predict_residual(stt.X[:3], stt.U[:3])
    assert r_mean.shape == (3, 7) and r_var.shape == (3, 3)
    tl.save(str(tmp_path))
    tl2 = TOL.OnlineLearner(tF, tcfg, device="cpu")
    tl2.gp = tl.gp
    tl2.load(str(tmp_path))
    np.testing.assert_array_equal(tl2.data.store.X.numpy(), stt.X.numpy())
    np.testing.assert_array_equal(tl2.gp.gp.Z.numpy(), tl.gp.gp.Z.numpy())


def test_rescue_path_flies_on_the_cpu():
    """``main_path.fly_safety`` on the rescue composition, four lanes
    starting inside the downdraft at 2.5-3.5 m/s: both arms fly, the filter
    intervenes, and it crashes no more lanes than the unfiltered arm."""
    from gpmpc_tpu_torch.main_path import fly_safety, safety_rescue_path

    sp = safety_rescue_path("cpu")
    x0 = torch.tensor([2.0, 7.0, 0.2, -0.1, -2.5, 0.05, 0.0]).repeat(4, 1)
    x0[:, 1] += torch.linspace(0.0, 2.0, 4)
    x0[:, 4] -= torch.linspace(0.0, 1.0, 4)
    out = fly_safety(sp, x0)
    assert out["lanes"] == 4
    assert out["intervention_rate"] > 0
    assert out["crash_count_filtered"] <= out["crash_count_unfiltered"]
    assert out["success_rate_delta"] == out["success_rate"] - out["success_rate_unfiltered"]


def _jax_online_safety():
    """``scripts/run_online_safety_tpu.py --filter-model gp --filter-n 8``
    (``:92-158``), built from the JAX package as the script builds it:
    returns the online controller's init, the filtered controller, the
    plant and the filter's model from the inner state."""
    from gpmpc_tpu.learning import OnlineGPMPCConfig as JOC
    from gpmpc_tpu.learning import make_online_gp_mpc_controller as jax_online
    from gpmpc_tpu.mpc import GPMPCConfig as JGC

    p, gust, steps = _JP, -1.5, 110
    base = JaxRTIConfig(N=20, dt=DT, accept_pri_tol=1e-2, condensed=True,
                        admm=JaxADMMConfig(max_iter=50, check_interval=50, scaling=2,
                                           polish=False, adaptive_rho=False, infeas_certs=False,
                                           iter_unroll=25, use_pallas="off"))
    xT = jnp.zeros(7).at[0].set(2.0)
    p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    wind = jnp.zeros(7).at[5].set(0.4).at[6].set(0.25)
    gust_accel = lambda x: gust * jax.nn.sigmoid((6.0 - x[1]) / 1.0)
    plant = lambda x, u: jr3.step(p_true, x, u, DT) + DT * (
        wind + jnp.zeros(7).at[4].set(gust_accel(x)))
    cinit, cstep = jax_online(jF, JOC(mpc=JGC(base=base, scp_iterations=1, tighten=True,
                                              rollout_gp_tape=True)),
                              xT, lambda x0: jax_cubic(x0, xT, 65, DT), steps, steps)
    backup = JS.EmergencyBrakingController(T_max=p.T_max, g_I=jnp.array([-1.0, 0.0, 0.0]))
    fcfg = JS.SafetyFilterConfig(N=8, dt=DT, u_min=jnp.array([0.0, -p.T_max, -p.T_max]),
                                 u_max=jnp.full(3, p.T_max))
    F_filter = lambda x, u: jF(x, u) + DT * jnp.zeros(7).at[4].set(gust_accel(x))

    def sf_from_inner(inner):
        prior = jnp.exp(inner.gp.gp.kernels.log_variance)

        def sf(x, u):
            m, v = inner.gp.predict_gated(x, u)
            w_vert = jnp.clip(1.0 - v[0] / jnp.maximum(prior[0], 1e-12), 0.0, 1.0)
            d = jnp.zeros(7).at[4:7].set(m)
            d = d.at[4].add((1.0 - w_vert) * gust_accel(x))
            return jF(x, u) + DT * d

        return sf

    finit, fstep = JS.make_filtered_controller(cinit, cstep, F_filter, backup,
                                               JS.DescentFunnelSet(0.6, 1.5), fcfg,
                                               step_fn_from_inner=sf_from_inner)
    return cinit, finit, fstep, plant, sf_from_inner


def _to64(obj):
    """A copy of a port dataclass (a GP, its store, its kernels) with every
    floating tensor in float64."""
    if torch.is_tensor(obj):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to64(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _jax64(tree):
    """A JAX pytree with every floating leaf in float64 (inside enable_x64)."""
    f = lambda a: (jnp.asarray(np.asarray(a, np.float64))
                   if np.issubdtype(np.asarray(a).dtype, np.floating) else a)
    return jax.tree.map(f, tree)


def test_online_safety_composition_matches_the_script():
    """``main_path.online_safety_path`` against the script's own
    composition (``run_online_safety_tpu.py:92-158``): four lanes of the
    artifact's initial states (``tests/fixtures/safety_x0.npz``: 394, 196
    and 477, which climbed in some later episode on the card, and 187),
    two episodes of 110 steps with the GP carried between them by each
    package's ``carry_gp_between_episodes``. Teacher forced: at every step
    the port gets the JAX package's state and controller state, so both
    filters read the same learned GPs.

    - The interventions are equal on every lane at every step.
    - The filter's model (nominal + the gated GP mean + the downdraft pad
      faded by the variance gate) on the GP state after each step, both
      packages evaluating the same f32 factors in float64: within 1e-9.
      In f32 the port lies no further from that value than twice the JAX
      package's own largest distance (the carried GPs' weights c reach
      ~4e3, so f32 alone moves the model step by up to ~4e-3).
    - u within 1e-3, or within twice the largest witness of f32 alone on
      that cycle: the JAX package's distance from its own float64 run, the
      port's distance from itself under a one-ulp change of the state (up
      or down), and from itself with its GP predictions evaluated in
      float64 (the 50 unconverged ADMM iterations move u by ~1e-3 before
      the GP switches on; the GP's f32 predictions by up to ~5e-3 after).
      Not compared on refit cycles (k mod 10 = 9):
      there each package refits 60-110 points at noise 1e-4 in f32 and the
      two refitted GPs move u by up to ~3 (their refits are held by their
      posterior in test_torch_online.py)."""
    from gpmpc_tpu.learning import carry_gp_between_episodes as jax_carry
    from gpmpc_tpu_torch.gp.structured_gp import Simple3DoFGP
    from gpmpc_tpu_torch.learning import carry_gp_between_episodes
    from gpmpc_tpu_torch.main_path import online_safety_path

    jcinit, jfinit, jfstep, jplant, jsf = _jax_online_safety()
    jstep = jax.jit(jax.vmap(jfstep, in_axes=(0, 0, None)))
    jplant_v = jax.jit(jax.vmap(jplant))
    jcarry = jax.jit(jax.vmap(lambda s, a: jax_carry(jcinit, s, a)))
    jsf_v = jax.jit(jax.vmap(lambda inner, x, u: jsf(inner)(x, u)))
    op = online_safety_path("cpu")
    finit, fstep = op.controller
    path = os.path.join(os.path.dirname(__file__), "fixtures", "safety_x0.npz")
    with np.load(path) as f:
        x0 = f["online"][[394, 196, 477, 187]]
    predict32 = Simple3DoFGP.predict

    def predict_in_f64(gp, x, u):
        m, v = predict32(_to64(gp), x.double(), u.double())
        return m.float(), v.float()

    def witness(js, ts, x, k, uj, ut, du):
        """The witnesses of f32 alone, cheapest first, until one is half
        of ``du``: the JAX package in float64, the port under a one-ulp
        change of the state up, with its GP predictions in float64, and
        under a one-ulp change down."""
        with jax.enable_x64():
            w = float(np.abs(np.asarray(uj, np.float64)
                             - np.asarray(jstep(_jax64(js), _jax64(x), k)[0])).max())
        xt = T(x)
        for run in ("up", "gp64", "down"):
            if 2.0 * w >= du:
                break
            if run == "gp64":
                with mock.patch.object(Simple3DoFGP, "predict", predict_in_f64):
                    u2 = fstep(ts, xt, k)[0]
            else:
                toward = torch.full_like(xt, float("inf") if run == "up" else float("-inf"))
                u2 = fstep(ts, torch.nextafter(xt, toward), k)[0]
            w = max(w, float((u2 - ut).abs().max()))
        return w

    def port_state(js):
        inner, *counters = js
        return (online_state_from_jax(inner),) + tuple(torch.tensor(np.asarray(a))
                                                      for a in counters)

    js = jax.vmap(jfinit)(J(x0))
    sf_err = {"port": 0.0, "jax": 0.0}
    n_int, n_cmp = 0, 0
    for episode in range(2):
        if episode:
            jin = jcarry(js[0], J(x0))
            tin = carry_gp_between_episodes(op.inner[0], port_state(js)[0], T(x0))
            np.testing.assert_allclose(tin.Xr.numpy(), np.asarray(jin.Xr), atol=1e-5)
            np.testing.assert_allclose(tin.mpc.X_lin.numpy(), np.asarray(jin.mpc.X_lin),
                                       atol=1e-5)
            np.testing.assert_array_equal(tin.gp.buffer_count.numpy(),
                                          np.asarray(jin.gp.buffer.count))
            js = (jin,) + tuple(jnp.zeros_like(s) for s in js[1:])
        x = J(x0)
        for k in range(110):
            ts = port_state(js)
            uj, js2 = jstep(js, x, k)
            if bool((x[:, 1] > 0.1).any()):
                msg = f"episode {episode + 1}, step {k}"
                ut, ts2 = fstep(ts, T(x), k)
                np.testing.assert_array_equal(ts2[1].numpy(), np.asarray(js2[1]), err_msg=msg)
                # the filter's model on the same GP state: float64, then f32
                inner2 = online_state_from_jax(js2[0])
                sf_t = op.filter_model(inner2)(T(x), T(uj))
                sf_64 = op.filter_model(dataclasses.replace(inner2, gp=_to64(inner2.gp)))(
                    T(x).double(), T(uj).double()).numpy()
                with jax.enable_x64():
                    sf_j64 = np.asarray(jsf_v(_jax64(js2[0]), _jax64(x), _jax64(uj)))
                np.testing.assert_allclose(sf_64, sf_j64, rtol=0, atol=1e-9, err_msg=msg)
                sf_err["port"] = max(sf_err["port"], float(np.abs(sf_t.numpy() - sf_64).max()))
                sf_err["jax"] = max(sf_err["jax"],
                                    float(np.abs(np.asarray(jsf_v(js2[0], x, uj)) - sf_64).max()))
                du = float(np.abs(ut.numpy() - np.asarray(uj)).max())
                if k % 10 != 9 and du > 1e-3:
                    assert du <= 2.0 * witness(js, ts, x, k, uj, ut, du), (
                        f"{msg}: |du| {du:.2e} is over twice every witness")
                n_cmp += k % 10 != 9
            js = js2
            x = jnp.where((x[:, 1] <= 0.1)[:, None], x, jplant_v(x, uj))
        n_int += int(np.asarray(js[1]).sum())
        assert bool((x[:, 1] <= 0.1).all())  # every lane landed
    assert n_int > 20 and n_cmp > 80  # the filter fired; most cycles were compared
    assert sf_err["port"] <= 2.0 * sf_err["jax"] + 1e-6, sf_err
