"""The port's 6-DoF slice (Path D) against the JAX package on the CPU: the
quaternion dynamics and their Jacobians, the control and constraint helpers,
``rti_config_6dof`` in every option, the translational and rotational
features, a JAX-fitted ``StructuredRocketGP`` carried across by
``gpmpc_tpu_torch.convert``, and five closed-loop cycles of the bench's 6-DoF
GP-MPC configuration. Inputs come from a numpy seed and go to both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxParams, rocket6dof as jr
from gpmpc_tpu.dynamics import trajectory_jacobians as jax_tj
from gpmpc_tpu.gp import ResidualCollector as JaxCollector
from gpmpc_tpu.gp import StructuredGPConfig as JaxGPConfig, StructuredRocketGP as JaxSGP
from gpmpc_tpu.gp import features as jf
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig
from gpmpc_tpu.mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
from gpmpc_tpu.mpc import rti6dof as jrti6
from gpmpc_tpu.mpc.rti import _condensed_admm_cfg as jax_condensed_admm_cfg
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket6DoFParams, rocket6dof as tr, trajectory_jacobians
from gpmpc_tpu_torch.gp import (ResidualCollector, StructuredGPConfig, StructuredRocketGP,
                                 features as tf)
from gpmpc_tpu_torch.learning import gp_fns
from gpmpc_tpu_torch.main_path import sixdof_path
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve, rti6dof as trti6
from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import ADMMConfig

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
N = 20
AERO = dict(rho=0.8, C_A=0.05 * np.eye(3, dtype=np.float32))
T = lambda a: torch.tensor(np.asarray(a))


def _params(aero=False):
    jp, tp = JaxParams(), Rocket6DoFParams(device="cpu")
    if aero:
        jp = jp.replace(rho=AERO["rho"], C_A=jnp.asarray(AERO["C_A"]))
        tp = tp.replace(**AERO)
    return jp, tp


def _states(seed=0, B=16):
    """Descent states with random unit quaternions near upright, small rates,
    and thrusts around hover; the last two rows have v = 0 and v_B[0] = 0
    (upright, no vertical speed)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 14), np.float32)
    x[:, 0] = 1.5 + 0.4 * rng.random(B)
    x[:, 1] = 5.0 + 15.0 * rng.random(B)
    x[:, 2:4] = rng.normal(size=(B, 2))
    x[:, 4:7] = np.array([-2.5, 0.2, -0.1]) + 0.8 * rng.normal(size=(B, 3))
    q = np.array([1.0, 0, 0, 0]) + 0.2 * rng.normal(size=(B, 4))
    x[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 11:14] = 0.2 * rng.normal(size=(B, 3))
    x[-2:, 7:11] = [1.0, 0.0, 0.0, 0.0]
    x[-2, 4:7] = 0.0
    x[-1, 4] = 0.0
    u = (np.array([2.0, 0.0, 0.0]) + 0.4 * rng.normal(size=(B, 3))).astype(np.float32)
    return x, u


# -- dynamics ------------------------------------------------------------------


@pytest.mark.parametrize("aero", [False, True], ids=["nominal", "aero"])
def test_f_and_step_match_jax(aero):
    """f and the renormalized RK4 step on random unit-quaternion states, v = 0
    included (the ε-smoothed norms): the same f32 arithmetic up to the order
    of the 3×3 products, rtol 1e-5 or atol 1e-5."""
    jp, tp = _params(aero)
    x, u = _states(1)
    for fj, ft in ((jr.f, tr.f), (lambda p, a, b: jr.step(p, a, b, DT),
                                  lambda p, a, b: tr.step(p, a, b, DT))):
        ref = jax.vmap(lambda a, b: fj(jp, a, b))(x, u)
        out = ft(tp, T(x), T(u))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.allclose(np.linalg.norm(out.numpy()[:, 7:11], axis=1), 1.0, atol=1e-6)
    # leading (B, K) dims, and the Euler integrator
    out2 = tr.f(tp, T(x).reshape(4, 4, 14), T(u).reshape(4, 4, 3))
    np.testing.assert_allclose(out2.reshape(16, 14).numpy(),
                               jax.vmap(lambda a, b: jr.f(jp, a, b))(x, u), rtol=1e-5, atol=1e-5)
    je, te = jp.replace(integrator="euler"), tp.replace(integrator="euler")
    np.testing.assert_allclose(
        tr.step(te, T(x), T(u), DT).numpy(),
        jax.vmap(lambda a, b: jr.step(je, a, b, DT))(x, u), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aero", [False, True], ids=["nominal", "aero"])
def test_trajectory_jacobians_match_jax(aero):
    """Forward-mode Jacobians of the renormalized step along trajectories
    (torch.func under vmap against jax.jacfwd), 1e-4."""
    jp, tp = _params(aero)
    x, u = _states(2, 12)
    X, U = x.reshape(3, 4, 14)[:, :3], u.reshape(3, 4, 3)[:, :2]  # 3 lanes, N = 2
    ref = jax.vmap(lambda a, b: jax_tj(lambda xx, uu: jr.step(jp, xx, uu, DT), a, b))(X, U)
    out = trajectory_jacobians(lambda xx, uu: tr.step(tp, xx, uu, DT), T(X), T(U))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-4)


def test_simulate_and_initial_state_match_jax():
    jp, tp = _params(True)
    x, u = _states(3, 4)
    U = np.stack([u] * 5, axis=1)
    ref = jax.vmap(lambda a, b: jr.simulate(jp, a, b, DT))(x, U)
    out = tr.simulate(tp, T(x), T(U), DT)
    assert out.shape == (4, 6, 14)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    kw = dict(altitude=12.0, horizontal=(0.5, -1.0), velocity=(-2.0, 0.1, 0.0))
    np.testing.assert_array_equal(tr.create_initial_state(tp, **kw).numpy(),
                                  jr.create_initial_state(jp, **kw))
    assert tr.create_initial_state(device="cpu").shape == (14,)


def test_control_and_constraint_helpers_match_jax():
    """clamp_thrust, clamp_gimbal, hover_thrust and the constraint evaluators
    inside and outside the gimbal cone, beyond both thrust limits and at
    u = 0 (the guarded directions), 1e-6."""
    jp, tp = _params()
    x, u = _states(4, 8)
    u = np.concatenate([u, [[0.0, 0.0, 0.0], [3.0, 2.5, -1.0], [8.0, 0.1, 0.1],
                            [0.5, 0.05, 0.0], [-1.0, 0.2, 0.3], [2.0, 0.0, 0.0],
                            [1.0, 0.0, 1.0], [4.0, -1.0, 0.5]]]).astype(np.float32)
    x = np.concatenate([x, x]).astype(np.float32)
    inside = np.degrees(np.arctan2(np.linalg.norm(u[:, 1:], axis=1), u[:, 0])) <= 20.0
    assert inside.any() and (~inside).any()
    for name in ("clamp_thrust", "clamp_gimbal"):
        ref = jax.vmap(lambda b: getattr(jr, name)(jp, b))(u)
        np.testing.assert_allclose(getattr(tr, name)(tp, T(u)).numpy(), ref, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(trti6.project_control_6dof(tp, T(u)).numpy(),
                               jax.vmap(lambda b: jrti6.project_control_6dof(jp, b))(u),
                               atol=1e-6)
    np.testing.assert_allclose(tr.hover_thrust(tp, T(x)).numpy(),
                               jax.vmap(lambda a: jr.hover_thrust(jp, a))(x), atol=1e-6)
    ref = jax.vmap(lambda a, b: jr.evaluate_constraints(jp, a, b))(x, u)
    out = tr.evaluate_constraints(tp, T(x), T(u))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tr.tilt_angle(T(x[:, 7:11])).numpy(),
                               jax.vmap(jr.tilt_angle)(x[:, 7:11]), atol=1e-5)
    np.testing.assert_allclose(tr.dcm_from_quaternion(T(x[:, 7:11])).numpy(),
                               jax.vmap(jr.dcm_from_quaternion)(x[:, 7:11]), atol=1e-6)


def test_params_carry_over_and_properties():
    jp = JaxParams().replace(rho=0.8, C_A=0.05 * jnp.eye(3), T_min=1.2)
    d = {f.name: (np.asarray(getattr(jp, f.name)) if hasattr(getattr(jp, f.name), "shape")
                  else getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    tp = convert.rocket6dof_params_from_fields(d, device="cpu")
    for name in ("J_B", "r_T_B", "r_cp_B", "g_I", "C_A"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    assert (tp.rho, tp.T_min, tp.integrator, tp.alpha) == (0.8, 1.2, "rk4", jp.alpha)
    assert float(tp.g) == pytest.approx(float(jp.g))
    torch.testing.assert_close(tp.J_B_inv @ tp.J_B, torch.eye(3), rtol=0, atol=1e-6)


def test_entry_points_default_to_cuda():
    """Without a card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for make in (Rocket6DoFParams, lambda: trti6.rti_config_6dof(),
                 lambda: StructuredRocketGP.create(), sixdof_path):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -- the 6-DoF RTI configuration ---------------------------------------------------

_MATRICES = ("Q", "R", "Qf", "x_min", "x_max", "u_min", "u_max",
             "Gx", "gx_l", "gx_u", "Gu", "gu_l", "gu_u")


@pytest.mark.parametrize("kw", [{}, {"cone_facets": 8}, {"glideslope_facets": 8},
                                {"glideslope_smooth": True}, {"bound_translation": False},
                                {"cone_facets": 6, "glideslope_smooth": True,
                                 "bound_translation": False}],
                         ids=["default", "cone", "glideslope", "smooth", "elided", "all"])
def test_rti_config_6dof_matches_jax(kw):
    """Every matrix and bound (exactly, up to f32 rounding of the facet
    angles: 1e-6), the scalar fields, the bound mask, and the declared
    condensed row structure."""
    jp, tp = _params()
    jc = jrti6.rti_config_6dof(jp, N=10, **kw)
    tc = trti6.rti_config_6dof(tp, N=10, **kw)
    for name in _MATRICES:
        r, o = getattr(jc, name), getattr(tc, name)
        assert (r is None) == (o is None), name
        if r is not None:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    for name in ("N", "dt", "n_x", "n_u", "x_bound_mask", "n_stage_rows"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (tc.stage_rows_fn is None) == (jc.stage_rows_fn is None)
    assert (tc.admm.max_iter, tc.admm.polish) == (jc.admm.max_iter, jc.admm.polish) == (100, True)
    assert _condensed_admm_cfg(tc.replace(condensed=True)).row_structure == \
        jax_condensed_admm_cfg(jc.replace(condensed=True)).row_structure


def test_glideslope_facets_and_smooth_together_raise():
    with pytest.raises(ValueError, match="pick one"):
        trti6.rti_config_6dof(Rocket6DoFParams(device="cpu"), glideslope_facets=8,
                              glideslope_smooth=True)


def test_glideslope_linearized_on_a_batch():
    """The per-stage linearized cone rows on (B, N+1, 14) trajectories,
    lanes on the cone axis (r = 0: the ε-smoothing) included, against the
    JAX function per lane: 1e-6."""
    x, _ = _states(5, 12)
    X = x.reshape(3, 4, 14)
    X[0, :, 2:4] = 0.0
    jfn = jrti6.glideslope_linearized(np.radians(30.0))
    tfn = trti6.glideslope_linearized(np.radians(30.0))
    ref = jax.vmap(jfn)(jnp.asarray(X))
    out = tfn(T(X))
    assert out[0].shape == (3, 3, 1, 14) and out[1].shape == out[2].shape == (3, 3, 1)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def jax_bench_6dof_config():
    """bench.py:345-353 (the 6-DoF cycle's configuration), with the plain
    ADMM iteration."""
    base = jrti6.rti_config_6dof(
        JaxParams(), N=N, bound_translation=False,
        admm=JaxADMMConfig(max_iter=60, check_interval=30, polish=False, adaptive_rho=False,
                           scaling=2, use_pallas="off", infeas_certs=False, iter_unroll=15),
    ).replace(accept_pri_tol=1e-2, condensed=True)
    return JaxGPMPCConfig(base=base, scp_iterations=1, tighten=True, rollout_gp_tape=True)


def test_sixdof_path_is_the_bench_config():
    """Path D declares the bench's rows, ``("blt", 5, 28, 12), ("diag", 60)``
    (n = 60, m = 200), and carries every field of its configuration."""
    sp = sixdof_path("cpu")
    jcfg = jax_bench_6dof_config()
    segs = _condensed_admm_cfg(sp.config.base).row_structure
    assert segs == jax_condensed_admm_cfg(jcfg.base).row_structure == (
        ("blt", 5, 28, 12), ("diag", 60))
    assert _n_rows(sp.config.base) == 200
    for name in ("N", "dt", "accept_pri_tol", "condensed", "x_bound_mask"):
        assert getattr(sp.config.base, name) == getattr(jcfg.base, name), name
    for name in ("max_iter", "check_interval", "polish", "adaptive_rho", "scaling",
                 "infeas_certs", "rho", "sigma", "alpha"):
        assert getattr(sp.config.base.admm, name) == getattr(jcfg.base.admm, name), name
    assert sp.config.base.admm.use_pallas == "auto"
    for name in ("scp_iterations", "tighten", "rollout_gp_tape", "confidence"):
        assert getattr(sp.config, name) == getattr(jcfg, name), name
    for name in _MATRICES[:7]:
        np.testing.assert_allclose(getattr(sp.config.base, name).numpy(),
                                   np.asarray(getattr(jcfg.base, name)), rtol=1e-7)
    np.testing.assert_array_equal(sp.x_target.numpy(),
                                  jr.create_initial_state(JaxParams(), altitude=0.0))


def test_rti6dof_controller_matches_jax():
    """Two steps of the projected 6-DoF RTI controller pair (condensed, N = 5,
    25 iterations, every state bound kept) at 3 lanes: u0 after the exact
    projection within 1e-3 (the condensed QP with its attitude rows active
    stops short of convergence, as test_torch_mpc.py's facet test says)."""
    jp, tp = _params()
    admm = dict(max_iter=25, polish=False, adaptive_rho=False, scaling=2)
    jc = jrti6.rti_config_6dof(jp, N=5, admm=JaxADMMConfig(use_pallas="off", **admm)).replace(
        condensed=True)
    tc = trti6.rti_config_6dof(tp, N=5, admm=ADMMConfig(**admm)).replace(condensed=True)
    x, _ = _states(6, 3)
    xT = jr.create_initial_state(jp, altitude=0.0)
    jinit, jstep = jrti6.make_rti6dof_controller(lambda a, b: jr.step(jp, a, b, DT), jp, jc, xT)
    tinit, tstep = trti6.make_rti6dof_controller(lambda a, b: tr.step(tp, a, b, DT), tp, tc,
                                                 np.asarray(xT))
    jcs, tcs = jax.vmap(jinit)(jnp.asarray(x)), tinit(T(x))
    jstep_all = jax.jit(lambda cs, xx, k: jax.vmap(lambda c, a: jstep(c, a, k))(cs, xx))
    xj, xt = jnp.asarray(x), T(x)
    for k in range(2):
        uj, jcs = jstep_all(jcs, xj, k)
        ut, tcs = tstep(tcs, xt, k)
        np.testing.assert_allclose(ut.numpy(), uj, atol=1e-3, err_msg=f"step {k}")
        xj = jax.vmap(lambda a, b: jr.step(jp, a, b, DT))(xj, uj)
        xt = tr.step(tp, xt, ut, DT)


# -- features ------------------------------------------------------------------


@pytest.mark.parametrize("which", ["translational", "rotational", "combined"])
def test_features_match_jax(which):
    """Both 6-DoF extractors and their concatenation, v = 0 and v_B[0] = 0
    (the α guard: sign(0 + 1e-12) and the 1e-8 floor) included: rtol 1e-5 or
    atol 1e-5."""
    x, u = _states(7)
    jfun = getattr(jf, f"{which}_features")
    tfun = getattr(tf, f"{which}_features")
    ref = jax.vmap(lambda a, b: jfun(a, b, jf.AtmosphereModel()))(x, u)
    out = tfun(T(x), T(u), tf.AtmosphereModel())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out.numpy()).all()
    if which == "translational":
        assert out.shape == (16, 13)
        np.testing.assert_allclose(out[-1, 5].item(), np.arctan2(x[-1, 6], 1e-8), rtol=1e-6)
    extractor = {"translational": tf.TranslationalFeatureExtractor,
                 "rotational": tf.RotationalFeatureExtractor,
                 "combined": tf.CombinedFeatureExtractor}[which]()
    assert extractor.n_features == out.shape[1]
    torch.testing.assert_close(extractor.extract(T(x).reshape(2, 8, 14), T(u).reshape(2, 8, 3)),
                               out.reshape(2, 8, -1))


# -- the structured GP -------------------------------------------------------------


def jax_structured_gp(n=64, M=24, seed=0):
    """A JAX ``StructuredRocketGP`` fitted on residuals of the dispersed plant
    (aero and wind) against the nominal model at descent states."""
    jp, _ = _params()
    jpt = jp.replace(rho=AERO["rho"], C_A=jnp.asarray(AERO["C_A"]))
    wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
    x, u = _states(10 + seed, n)
    X, U = jnp.asarray(x), jnp.asarray(u)
    Xn = jax.vmap(lambda a, b: jr.step(jpt, a, b, DT) + DT * wind)(X, U)
    R = JaxCollector(dt=DT).collect_batch(lambda a, b: jr.step(jp, a, b, DT), X, U, Xn)
    gp = JaxSGP.create(JaxGPConfig(max_data_points=n, n_inducing=M))
    return gp.add_data_batch(X, U, R).fit(jax.random.PRNGKey(seed))


def jax_sgp_to_numpy(gp) -> dict:
    """The dict ``convert.structured_rocket_gp_from_numpy`` takes."""
    out = {}
    for prefix, g, b in (("trans_", gp.trans_gp, gp.trans_buffer), ("rot_", gp.rot_gp, gp.rot_buffer)):
        d = dict(Z=g.Z, X=g.X, Y=g.Y, mask=g.mask, log_noise=g.log_noise,
                 log_lengthscales=g.kernels.log_lengthscales, log_variance=g.kernels.log_variance,
                 Luu_inv=g.Luu_inv, LB_inv=g.LB_inv, c=g.c, buffer_X=b.X, buffer_Y=b.Y,
                 buffer_head=b.head, buffer_count=b.count)
        out.update({prefix + k: np.asarray(v) for k, v in d.items()})
        out[prefix + "method"] = g.method
    out["config"] = {f: getattr(gp.config, f) for f in ("max_data_points", "n_inducing", "noise")}
    return out


@pytest.fixture(scope="module")
def shared_sgp():
    gp = jax_structured_gp()
    return gp, convert.structured_rocket_gp_from_numpy(jax_sgp_to_numpy(gp), device="cpu")


def test_structured_gp_carried_across_predicts_like_jax(shared_sgp):
    """predict, predict_gated and lift_residual of the carried state on
    held-out points, at test_torch_gp.py's 1e-5; the port's refit of the
    carried stores equals JAX's refit."""
    gp, tgp = shared_sgp
    assert tgp.is_fitted and int(tgp.buffer_count) == 64 and tgp.config.n_inducing == 24
    x, u = _states(42, 24)
    m_j, v_j = jax.vmap(gp.predict)(x, u)
    g_j, _ = jax.vmap(gp.predict_gated)(x, u)
    m_t, v_t = tgp.predict(T(x), T(u))
    g_t, _ = tgp.predict_gated(T(x), T(u))
    assert m_t.shape == v_t.shape == (24, 6)
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)
    mb, vb = jax.jit(gp.predict_batch)(jnp.asarray(x), jnp.asarray(u))
    m2, _ = tgp.predict_batch(T(x).reshape(4, 6, 14), T(u).reshape(4, 6, 3))
    np.testing.assert_allclose(m2.reshape(24, 6).numpy(), mb, atol=1e-5)
    lifted = StructuredRocketGP.lift_residual(g_t, 14)
    np.testing.assert_allclose(lifted.numpy(), jax.vmap(lambda r: JaxSGP.lift_residual(r, 14))(g_j),
                               atol=1e-5)
    np.testing.assert_allclose(StructuredRocketGP.lift_residual(g_t, 7).numpy(),
                               jax.vmap(lambda r: JaxSGP.lift_residual(r, 7))(g_j), atol=1e-5)
    # a refit recomputes the factors in f32 (noise 1e-4, so c = LB⁻¹A·y is
    # O(1e2) through cancellation): the refitted GPs predict alike at
    # test_torch_gp.py's fit tolerances, means within 5e-3, variances 1e-3
    rj, rt = gp.refit(), tgp.refit()
    m_j, v_j = jax.vmap(rj.predict)(x, u)
    m_t, v_t = rt.predict(T(x), T(u))
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=5e-3)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-3)
    mean_fn, var_fn = gp_fns(tgp)
    assert mean_fn(T(x), T(u)).shape == (24, 14) and var_fn(T(x), T(u)).shape == (24, 6)


def test_structured_gp_fit_matches_jax_from_the_same_start():
    """The port's fit on the same data from the k-means starts the JAX fit
    draws (one key split into the translational and the rotational draw):
    the inducing points within 1e-3 (two f32 k-means chains), and the
    predictions at test_torch_gp.py's fit tolerances (the residual targets
    differ at the f32 level over dt and the fit amplifies that through c):
    means within 5e-3, variances within 1e-3."""
    gp = jax_structured_gp(48, 16, seed=1)
    n = 48
    idx = tuple(np.asarray(jax.random.choice(k, n, (16,), replace=False, p=jnp.full(n, 1.0 / n)))
                for k in jax.random.split(jax.random.PRNGKey(1)))
    x, u = _states(11, 48)
    jp, tp = _params()
    tpt = tp.replace(**AERO)
    wind = torch.zeros(14)
    wind[5], wind[6] = 0.10, 0.06
    Xn = tr.step(tpt, T(x), T(u), DT) + DT * wind
    R = ResidualCollector(dt=DT).collect_batch(lambda a, b: tr.step(tp, a, b, DT), T(x), T(u), Xn)
    tgp = StructuredRocketGP.create(StructuredGPConfig(max_data_points=n, n_inducing=16),
                                    device="cpu").add_data_batch(T(x), T(u), R)
    tgp = tgp.fit(init_idx=tuple(T(i) for i in idx))
    np.testing.assert_allclose(tgp.trans_buffer.X.numpy(), gp.trans_buffer.X, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgp.rot_buffer.Y.numpy(), gp.rot_buffer.Y, atol=2e-3)
    np.testing.assert_allclose(tgp.trans_gp.Z.numpy(), gp.trans_gp.Z, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tgp.rot_gp.Z.numpy(), gp.rot_gp.Z, rtol=1e-3, atol=1e-3)
    xq, uq = _states(12, 8)
    m_j, v_j = jax.vmap(gp.predict)(xq, uq)
    m_t, v_t = tgp.predict(T(xq), T(uq))
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=5e-3)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-3)


# -- the Path D cycle ----------------------------------------------------------------


def test_sixdof_cycle_closed_loop_matches_jax(shared_sgp):
    """Five closed-loop cycles of the bench's 6-DoF configuration at 4 lanes
    (n = 60, m = 200: the 140 attitude and rate bound rows live, 60
    iterations in two chunks of 30) under the dispersed plant, same GP state
    and same initial states in both packages: u0 and X_opt within 2e-4 of
    max(1, |x|) per entry (the first slice's tolerance, scaled as the earlier
    slices scale it), the acceptance flags equal."""
    gp, tgp = shared_sgp
    jcfg = jax_bench_6dof_config()
    sp = sixdof_path("cpu")
    jp, _ = _params()
    jpt = jp.replace(rho=AERO["rho"], C_A=jnp.asarray(AERO["C_A"]))
    wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
    jF = lambda a, b: jr.step(jp, a, b, DT)
    jF_true = lambda a, b: jr.step(jpt, a, b, DT) + DT * wind
    jmean = lambda a, b: JaxSGP.lift_residual(gp.predict_gated(a, b)[0], 14)
    jvar = lambda a, b: gp.predict(a, b)[1]
    tmean, tvar = gp_fns(tgp)
    rng = np.random.default_rng(3)
    x0s = np.tile(np.asarray(jr.create_initial_state(jp, altitude=0.0, velocity=(-2.0, 0.1, 0.0))),
                  (4, 1))
    x0s[:, 1] = 15.0 + 2.0 * rng.normal(size=4)
    xT = np.asarray(sp.x_target)
    js = jax.vmap(lambda a: jax_init(jcfg, a, jnp.asarray(xT)))(jnp.asarray(x0s))
    ts = gp_mpc_init(sp.config, x0s, xT, device="cpu")
    assert ts.y_prev.shape == js.y_prev.shape == (4, 200)
    jstep = jax.jit(jax.vmap(lambda s, a: jax_solve(jF, jmean, jvar, jcfg, s, a)))
    xj, xt = jnp.asarray(x0s), T(x0s)
    before = K.LAUNCHES
    for k in range(5):
        sj, js = jstep(js, xj)
        st, ts = gp_mpc_solve(sp.F, tmean, tvar, sp.config, ts, xt)
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, rtol=2e-4, atol=2e-4, err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, rtol=2e-4, atol=2e-4,
                                   err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        assert bool(torch.isfinite(st.Sigmas).all())
        xj = jax.vmap(jF_true)(xj, sj.u0)
        xt = sp.F_true(xt, st.u0)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=2e-4, atol=2e-4)
    assert K.LAUNCHES == before  # CPU tensors run the plain version
    # the propagated covariances that tighten the attitude and rate rows,
    # within 1e-5 of their largest entry
    np.testing.assert_allclose(st.Sigmas.numpy(), sj.Sigmas,
                               atol=1e-5 * float(np.abs(sj.Sigmas).max()))
