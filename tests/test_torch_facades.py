"""The dynamics facades ``Rocket3DoF``/``Rocket6DoF``, their module
functions, the integrators and the linearization utilities of the port
against the JAX package, on the same NumPy inputs (16 random lanes).

Tolerances: values at 1e-5 relative (atol 1e-6), Jacobians at 1e-4 relative
(atol 1e-5): the same f32 arithmetic, differentiated by each package's own
forward mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import dynamics as JD
from gpmpc_tpu.dynamics import rocket3dof as jr3, rocket6dof as jr6
from gpmpc_tpu_torch import dynamics as TD
from gpmpc_tpu_torch.dynamics import rocket3dof as tr3, rocket6dof as tr6

torch.set_num_threads(1)  # the suite's xdist workers share the cores

B = 16
DT = 0.1
VAL = dict(rtol=1e-5, atol=1e-6)
JAC = dict(rtol=1e-4, atol=1e-5)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(a, b, tol=VAL):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], tol)
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    else:
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


def _lanes3(seed=0):
    rng = np.random.default_rng(seed)
    x = (np.array([1.8, 15, 0, 0, -3, 0, 0]) + rng.normal(size=(B, 7))
         * np.array([0.1, 5, 2, 2, 1, 0.5, 0.5])).astype(np.float32)
    u = (np.array([2.0, 0, 0]) + 0.8 * rng.normal(size=(B, 3))).astype(np.float32)
    return x, u


def _lanes6(seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 14), np.float32)
    x[:, :7] = (np.array([1.8, 15, 0, 0, -3, 0, 0]) + rng.normal(size=(B, 7))
                * np.array([0.1, 5, 2, 2, 1, 0.5, 0.5]))
    q = np.array([1.0, 0, 0, 0]) + 0.2 * rng.normal(size=(B, 4))
    x[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 11:14] = 0.2 * rng.normal(size=(B, 3))
    u = (np.array([2.5, 0, 0]) + 0.5 * rng.normal(size=(B, 3))).astype(np.float32)
    return x, u


MODELS = {
    "3dof": (lambda: jr3.Rocket3DoF(jr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1)),
             lambda: tr3.Rocket3DoF(tr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1,
                                                         device="cpu")), _lanes3),
    "6dof": (lambda: jr6.create_szmuk_rocket(), lambda: tr6.create_szmuk_rocket("cpu"), _lanes6),
}

# (method, takes, tolerance): "xu" (x, u), "x", "u"
METHODS = [("f", "xu", VAL), ("step", "xu", VAL), ("jacobian_x", "xu", JAC),
           ("jacobian_u", "xu", JAC), ("linearize", "xu", JAC), ("linearize_discrete", "xu", JAC),
           ("thrust_constraint", "u", VAL), ("glide_slope_constraint", "x", VAL),
           ("evaluate_constraints", "xu", VAL), ("hover_thrust", "x", VAL),
           ("clamp_thrust", "u", VAL), ("fuel_remaining", "x", VAL),
           ("fuel_fraction", "x", VAL)]
METHODS6 = [("get_dcm", "x", VAL), ("get_tilt_angle", "x", VAL), ("gimbal_constraint", "u", VAL),
            ("tilt_constraint", "x", VAL), ("angular_rate_constraint", "x", VAL),
            ("clamp_gimbal", "u", VAL)]


def _call(obj, name, takes, x, u, torch_side):
    args = {"xu": (x, u), "x": (x,), "u": (u,)}[takes]
    if torch_side:
        return getattr(obj, name)(*[torch.tensor(a) for a in args])
    return jax.vmap(getattr(obj, name))(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("model", ["3dof", "6dof"])
@pytest.mark.parametrize("name,takes,tol", METHODS, ids=[m[0] for m in METHODS])
def test_facade_method_matches_jax(model, name, takes, tol):
    make_j, make_t, lanes = MODELS[model]
    x, u = lanes()
    _close(_call(make_t(), name, takes, x, u, True), _call(make_j(), name, takes, x, u, False),
           tol)


@pytest.mark.parametrize("name,takes,tol", METHODS6, ids=[m[0] for m in METHODS6])
def test_facade_6dof_method_matches_jax(name, takes, tol):
    x, u = _lanes6(1)
    _close(_call(tr6.create_szmuk_rocket("cpu"), name, takes, x, u, True),
           _call(jr6.create_szmuk_rocket(), name, takes, x, u, False), tol)


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_facade_simulate_and_discrete_linearization_with_dt(model):
    make_j, make_t, lanes = MODELS[model]
    x, u = lanes(2)
    rng = np.random.default_rng(3)
    U = (u[:, None] + 0.1 * rng.normal(size=(B, 6, 3))).astype(np.float32)
    jm, tm = make_j(), make_t()
    _close(tm.simulate(torch.tensor(x), torch.tensor(U), 0.05),
           jax.vmap(lambda a, b: jm.simulate(a, b, 0.05))(x, U))
    _close(tm.linearize(torch.tensor(x), torch.tensor(u), DT),
           jax.vmap(lambda a, b: jm.linearize(a, b, DT))(x, u), JAC)
    _close(tm.linearize_discrete(torch.tensor(x), torch.tensor(u), 0.05),
           jax.vmap(lambda a, b: jm.linearize_discrete(a, b, 0.05))(x, u), JAC)


@pytest.mark.parametrize("fn", ["A_continuous", "B_continuous", "linearize_continuous",
                                "linearize_discrete_euler"])
def test_rocket3dof_module_jacobians_match_jax(fn):
    x, u = _lanes3(4)
    jp, tp = jr3.Rocket3DoFParams(), tr3.Rocket3DoFParams(device="cpu")
    ref = jax.vmap(lambda a, b: getattr(jr3, fn)(jp, a, b))(x, u)
    _close(getattr(tr3, fn)(tp, torch.tensor(x), torch.tensor(u)), ref, JAC)


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_create_initial_state_and_bounds(model):
    make_j, make_t, _ = MODELS[model]
    jm, tm = make_j(), make_t()
    kw = dict(altitude=12.0, mass=1.7, horizontal=(0.5, -0.25), velocity=(-2.0, 0.1, 0.2))
    _close(tm.create_initial_state(**kw), jm.create_initial_state(**kw))
    _close(tm.create_initial_state(), jm.create_initial_state())
    if model == "3dof":
        _close(tm.get_control_bounds(), jm.get_control_bounds())
        _close(tm.get_state_bounds(), jm.get_state_bounds())
        assert (tm.n_state, tm.n_control) == (7, 3)
    else:
        assert (tm.n_state, tm.n_control) == (14, 3)


@pytest.mark.parametrize("preset", ["normalized", "fuel_optimal"])
def test_create_rocket_3dof_presets(preset):
    jm, tm = jr3.create_rocket_3dof(preset), tr3.create_rocket_3dof(preset, "cpu")
    for k in ("m_dry", "m_wet", "I_sp", "g0", "T_min", "T_max"):
        assert getattr(tm.params, k) == getattr(jm.params, k)
    np.testing.assert_array_equal(tm.params.g_I.numpy(), np.asarray(jm.params.g_I))
    with pytest.raises(ValueError):
        tr3.create_rocket_3dof("nope", "cpu")


def test_create_szmuk_rocket_parameters_exactly():
    jp, tp = jr6.create_szmuk_rocket().params, tr6.create_szmuk_rocket("cpu").params
    for k in ("m_dry", "m_wet", "I_sp", "g0", "T_min", "T_max", "delta_max", "theta_max",
              "gamma_gs", "omega_max", "rho", "S_ref", "default_dt", "integrator"):
        assert getattr(tp, k) == getattr(jp, k), k
    for k in ("J_B", "r_T_B", "r_cp_B", "g_I", "C_A"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)))


def test_facade_aliases_and_exports():
    assert TD.Rocket3DoFDynamics is TD.Rocket3DoF and TD.Rocket6DoFDynamics is TD.Rocket6DoF
    assert TD.Rocket3DoFConfig is TD.Rocket3DoFParams
    assert TD.Rocket6DoFConfig is TD.Rocket6DoFParams
    assert set(JD.__all__) <= set(TD.__all__)


# -- integrators -------------------------------------------------------------


def _quats(seed, n=B):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32), \
        (0.5 * rng.normal(size=(n, 3))).astype(np.float32)


def test_quaternion_functions_match_jax():
    q, w = _quats(0)
    q2, _ = _quats(1)
    w[0] = 0.0  # the exponential step is exact at ω = 0
    T = lambda a: torch.tensor(a)
    _close(TD.quaternion_multiply(T(q), T(q2)), jax.vmap(JD.quaternion_multiply)(q, q2))
    _close(TD.quaternion_derivative(T(q), T(w)), jax.vmap(JD.quaternion_derivative)(q, w))
    _close(TD.quaternion_euler_step(T(q), T(w), DT),
           jax.vmap(lambda a, b: JD.quaternion_euler_step(a, b, DT))(q, w))
    out = TD.quaternion_exponential_step(T(q), T(w), DT)
    _close(out, jax.vmap(lambda a, b: JD.quaternion_exponential_step(a, b, DT))(q, w))
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, atol=1e-6)
    _close(out[0], q[0])


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_integrate_trajectory_and_sensitivity_match_jax(method):
    x, u = _lanes3(5)
    rng = np.random.default_rng(6)
    U = (u[:4, None] + 0.1 * rng.normal(size=(4, 5, 3))).astype(np.float32)
    jp = jr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1)
    tp = tr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1, device="cpu")
    jf, tf = (lambda a, b: jr3.f(jp, a, b)), (lambda a, b: tr3.f(tp, a, b))
    _close(TD.integrate_trajectory(tf, torch.tensor(x[:4]), torch.tensor(U), DT, method),
           jax.vmap(lambda a, b: JD.integrate_trajectory(jf, a, b, DT, method))(x[:4], U))
    out = TD.integrate_sensitivity(tf, torch.tensor(x[:4]), torch.tensor(U), DT, method)
    ref = jax.vmap(lambda a, b: JD.integrate_sensitivity(jf, a, b, DT, method))(x[:4], U)
    _close(out[0], ref[0])
    _close(out[1:], ref[1:], JAC)


def test_collocation_defects_match_jax():
    x, u = _lanes3(7)
    x1, u1 = _lanes3(8)
    jp, tp = jr3.Rocket3DoFParams(), tr3.Rocket3DoFParams(device="cpu")
    jf, tf = (lambda a, b: jr3.f(jp, a, b)), (lambda a, b: tr3.f(tp, a, b))
    T = lambda a: torch.tensor(a)
    for name in ("trapezoidal_defect", "hermite_simpson_defect"):
        out = getattr(TD, name)(tf, T(x), T(x1), T(u), T(u1), DT)
        ref = jax.vmap(lambda a, b, c, d: getattr(JD, name)(jf, a, b, c, d, DT))(x, x1, u, u1)
        _close(out, ref, dict(rtol=1e-5, atol=1e-5))


# -- linearization -----------------------------------------------------------


@pytest.mark.parametrize("method", ["forward", "central"])
def test_numerical_jacobians_match_jax_and_ad(method):
    x, u = _lanes3(9)
    tp = tr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1, device="cpu")
    jp = jr3.Rocket3DoFParams(rho=1.0, C_D=1.0, A_ref=0.1)
    tf, jf = (lambda a, b: tr3.f(tp, a, b)), (lambda a, b: jr3.f(jp, a, b))
    out = TD.numerical_jacobians(tf, torch.tensor(x), torch.tensor(u), method=method)
    ref = jax.vmap(lambda a, b: JD.numerical_jacobians(jf, a, b, method=method))(x, u)
    # f32 differences over eps = 1e-3: each package's rounding of f(x ± e)
    _close(out, ref, dict(rtol=1e-3, atol=2e-3))
    ad = TD.ad_jacobians(tf, torch.tensor(x), torch.tensor(u))
    _close(ad, jax.vmap(lambda a, b: JD.ad_jacobians(jf, a, b))(x, u), JAC)
    _close(out, ad, dict(rtol=1e-2, atol=2e-2 if method == "forward" else 2e-3))


def test_verify_jacobians_reports_like_jax():
    x, u = _lanes3(10)
    tp, jp = tr3.Rocket3DoFParams(device="cpu"), jr3.Rocket3DoFParams()
    tf, jf = (lambda a, b: tr3.f(tp, a, b)), (lambda a, b: jr3.f(jp, a, b))
    rep = TD.verify_jacobians(tf, lambda a, b: TD.ad_jacobians(tf, a, b), torch.tensor(x[0]),
                              torch.tensor(u[0]))
    ref = JD.verify_jacobians(jf, lambda a, b: JD.ad_jacobians(jf, a, b), x[0], u[0])
    assert rep["ok"] and ref["ok"] and set(rep) == set(ref)
    # a wrong Jacobian is caught
    bad = TD.verify_jacobians(tf, lambda a, b: tuple(2 * t for t in TD.ad_jacobians(tf, a, b)),
                              torch.tensor(x[0]), torch.tensor(u[0]))
    assert not bad["ok"] and bad["A_max_err"] > 1e-2


def test_affine_model_matches_jax():
    x, u = _lanes3(11)
    tp, jp = tr3.Rocket3DoFParams(device="cpu"), jr3.Rocket3DoFParams()
    tF, jF = (lambda a, b: tr3.step(tp, a, b, DT)), (lambda a, b: jr3.step(jp, a, b, DT))
    tm = TD.AffineModel.from_linearization(tF, torch.tensor(x), torch.tensor(u))
    jm = jax.vmap(lambda a, b: JD.AffineModel.from_linearization(jF, a, b))(x, u)
    _close(tuple(tm), tuple(jm), JAC)
    x2, u2 = _lanes3(12)
    _close(tm.predict(torch.tensor(x2), torch.tensor(u2)),
           jax.vmap(lambda m, a, b: m.predict(a, b))(jm, x2, u2), dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("method", ["euler", "taylor2", "zoh"])
def test_discretize_jacobians_matches_jax(method):
    x, u = _lanes3(13)
    tp = tr3.Rocket3DoFParams(device="cpu")
    A, Bc = tr3.linearize_continuous(tp, torch.tensor(x[0]), torch.tensor(u[0]))
    out = TD.discretize_jacobians(A, Bc, DT, method)
    ref = JD.discretize_jacobians(jnp.asarray(A.numpy()), jnp.asarray(Bc.numpy()), DT, method)
    _close(out, ref, dict(rtol=1e-5, atol=1e-6))
    with pytest.raises(ValueError):
        TD.discretize_jacobians(A, Bc, DT, "nope")


def test_trajectory_jacobians_take_per_lane_arguments():
    """The per-lane time step of the SCVX sweep: lane b linearized at dt_b
    equals a call at that dt alone."""
    x, u = _lanes3(14)
    tp = tr3.Rocket3DoFParams(device="cpu")
    X = torch.tensor(x[:3])[:, None].repeat(1, 3, 1)
    U = torch.tensor(u[:3])[:, None].repeat(1, 2, 1)
    dts = torch.tensor([0.1, 0.2, 0.3])
    out = TD.trajectory_jacobians(lambda a, b, d: tr3.step(tp, a, b, d), X, U, dts[:, None])
    for b in range(3):
        one = TD.trajectory_jacobians(lambda a, c: tr3.step(tp, a, c, float(dts[b])),
                                      X[b:b + 1], U[b:b + 1])
        for o, r in zip(out, one):
            np.testing.assert_allclose(o[b].numpy(), r[0].numpy(), rtol=1e-6, atol=1e-6)
    assert not math.isclose(float(out[0][0, 0, 1, 4]), float(out[0][2, 0, 1, 4]))
