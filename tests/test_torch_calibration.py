"""The calibration path's modules against the JAX package on the CPU: the
GP-MPC controller factory, one bound-riding cycle of the calibration
configuration, the Monte-Carlo helpers it uses, and its declared row
structure. Inputs come from a numpy seed and go to both packages."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.experiments import monte_carlo as jmc
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig, RTIConfig as JaxRTIConfig
from gpmpc_tpu.mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
from gpmpc_tpu.mpc import make_gp_mpc_controller as jax_make_controller
from gpmpc_tpu.mpc.gp_mpc import SimpleGPPredictor as JaxPredictor
from gpmpc_tpu.mpc.rti import _condensed_admm_cfg as jax_condensed_admm_cfg
from gpmpc_tpu.mpc.uncertainty_prop import box_tightening as jax_box
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.reference import cubic_descent_reference as jax_cubic
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.experiments import (CRASH, SUCCESS, LandingCriteria, SimulationConfig,
                                         classify_touchdown, sample_initial_conditions,
                                         wilson_interval)
from gpmpc_tpu_torch.gp import Simple3DoFGP
from gpmpc_tpu_torch.main_path import (GUST_SIGMA, V_LIM, calibration_path, calibration_x0,
                                       fly_calibration, with_gust_variance)
from gpmpc_tpu_torch.mpc import (SimpleGPPredictor, gp_mpc_init, gp_mpc_solve,
                                 make_gp_mpc_controller)
from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
from gpmpc_tpu_torch.mpc.uncertainty_prop import box_tightening
from gpmpc_tpu_torch.reference import cubic_descent_reference

sys.path.insert(0, "tests")
from test_torch_gp import jax_explore_gp, jax_gp_to_numpy  # noqa: E402
from test_torch_mpc import jax_bench_config, port_config  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
N = 20
X_TARGET = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def gps():
    """One JAX-fitted GP (the bench's) as both packages' (mean_fn, var_fn);
    the variance carries the calibration campaign's gust power."""
    gp = jax_explore_gp()
    tgp = convert.simple3dof_gp_from_numpy(jax_gp_to_numpy(gp), device="cpu")
    s2 = GUST_SIGMA**2
    jfns = (lambda x, u: gp.lift_residual(gp.predict_gated(x, u)[0], 7),
            lambda x, u: gp.predict(x, u)[1] + s2)
    tfns = (lambda x, u: Simple3DoFGP.lift_residual(tgp.predict_gated(x, u)[0], 7),
            with_gust_variance(lambda x, u: tgp.predict(x, u)[1]))
    return jfns, tfns


def _steps():
    jp, tp = JaxParams(), Rocket3DoFParams(device="cpu")
    return (lambda x, u: jr.step(jp, x, u, DT)), (lambda x, u: tr.step(tp, x, u, DT))


def _x0s(B, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.array([2.0, 16.0, 0.0, 0.0, -1.5, 0.0, 0.0], np.float32)
    spread = np.array([0.03, 1.0, 0.5, 0.5, 0.2, 0.1, 0.1], np.float32)
    return (x0 + spread * rng.normal(size=(B, 7))).astype(np.float32)


@pytest.mark.parametrize("with_reference", [False, True], ids=["constant-target", "reference"])
def test_gp_mpc_controller_matches_jax(gps, with_reference):
    """Three steps of the controller pair at 4 lanes in the bench
    configuration; with a reference the horizon is 2, so the third step
    (k = 2) lies past ``ref_horizon`` and tracks the last window. u0 and the
    carried plan (the shifted X_opt) within 2e-4, as the closed-loop test of
    test_torch_mpc.py holds the cycle."""
    (jmean, jvar), (tmean, tvar) = gps
    jF, tF = _steps()
    jcfg = jax_bench_config()
    cfg = port_config(jcfg)
    kw = {}
    tkw = {}
    if with_reference:
        kw = dict(reference_fn=lambda x0: jax_cubic(x0, jnp.asarray(X_TARGET), 12, DT),
                  ref_horizon=2)
        tkw = dict(reference_fn=lambda x0: cubic_descent_reference(
            x0, torch.tensor(X_TARGET), 12, DT), ref_horizon=2)
    jinit, jstep = jax_make_controller(jF, jmean, jvar, jcfg, jnp.asarray(X_TARGET), **kw)
    tinit, tstep = make_gp_mpc_controller(tF, tmean, tvar, cfg, X_TARGET, **tkw)
    x0s = _x0s(4)
    jcs = jax.vmap(jinit)(jnp.asarray(x0s))
    tcs = tinit(torch.tensor(x0s))
    if with_reference:
        assert tcs[1].shape == jcs[1].shape == (4, 2 + N + 1, 7)
        np.testing.assert_allclose(tcs[1].numpy(), jcs[1], atol=1e-5)
    jstep_all = jax.jit(lambda cs, x, k: jax.vmap(lambda c, xx: jstep(c, xx, k))(cs, x))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    for k in range(3):
        uj, jcs = jstep_all(jcs, xj, jnp.asarray(k))
        ut, tcs = tstep(tcs, xt, k)
        jstate, tstate = (jcs[0], tcs[0]) if with_reference else (jcs, tcs)
        np.testing.assert_allclose(ut.numpy(), uj, atol=2e-4, err_msg=f"step {k}")
        np.testing.assert_allclose(tstate.X_lin.numpy(), jstate.X_lin, atol=2e-4,
                                   err_msg=f"step {k}")
        if with_reference:
            kk = min(k, 1)
            np.testing.assert_allclose(tstate.x_ref.numpy(), jcs[1][:, kk:kk + N + 1], atol=1e-5)
        xj = jax.vmap(jF)(xj, uj)
        xt = tF(xt, ut)


def test_simple_gp_predictor_matches_jax(gps):
    (jmean, _), (tmean, _) = gps
    jF, tF = _steps()
    rng = np.random.default_rng(1)
    x0s = _x0s(3)
    U = (np.array([2.0, 0, 0]) + 0.3 * rng.normal(size=(3, 6, 3))).astype(np.float32)
    ref = jax.vmap(JaxPredictor(jF, jmean, DT).rollout)(jnp.asarray(x0s), jnp.asarray(U))
    out = SimpleGPPredictor(tF, tmean, DT).rollout(torch.tensor(x0s), torch.tensor(U))
    assert out.shape == (3, 7, 7)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def jax_calibration_config():
    """scripts/run_calibration_tpu.py:90-132 at confidence 0.95."""
    return JaxGPMPCConfig(
        base=JaxRTIConfig(
            N=N, dt=DT,
            x_min=jnp.array([-1e20, -100.0, -100.0, -100.0, V_LIM, -50.0, -50.0]),
            accept_pri_tol=1e-2, condensed=True,
            admm=JaxADMMConfig(max_iter=50, check_interval=50, scaling=2, polish=False,
                               adaptive_rho=False, infeas_certs=False, iter_unroll=25,
                               use_pallas="off")),
        scp_iterations=1, tighten=True, confidence=0.95, rollout_gp_tape=True)


def test_calibration_path_declares_the_jax_row_structure():
    cp = calibration_path("cpu")
    segs = _condensed_admm_cfg(cp.config.base).row_structure
    assert segs == jax_condensed_admm_cfg(jax_calibration_config().base).row_structure
    assert segs == (("blt", 5, 28, 12), ("diag", 60)) and _n_rows(cp.config.base) == 200
    jcfg = jax_calibration_config()
    for name in ("accept_pri_tol", "condensed", "N", "dt"):
        assert getattr(cp.config.base, name) == getattr(jcfg.base, name)
    for name in ("max_iter", "check_interval", "scaling", "polish", "adaptive_rho",
                 "infeas_certs"):
        assert getattr(cp.config.base.admm, name) == getattr(jcfg.base.admm, name)
    np.testing.assert_array_equal(cp.config.base.x_min.numpy(), np.asarray(jcfg.base.x_min))
    assert (cp.config.confidence, cp.config.scp_iterations, cp.config.rollout_gp_tape,
            cp.config.tighten) == (0.95, 1, True, True)


def test_bound_riding_cycle_matches_jax(gps):
    """Cycles of the calibration configuration from the same states in both
    packages, each lane tracking its fast descent reference: by the third
    cycle some lanes' plan rides the tightened descent-speed bound (some knot's v
    sits on x_min[4] + back-off in both packages). Tolerance 1e-3, as for the
    other cycles whose 50 iterations end on active rows (test_torch_mpc.py's
    facet test): the iterate is then several times more sensitive to f32
    reordering than on the box-free main path."""
    (jmean, jvar), (tmean, tvar) = gps
    jF, tF = _steps()
    jcfg = jax_calibration_config()
    cp = calibration_path("cpu")
    cfg = cp.config
    x0s = _x0s(4, seed=2)
    xT = jnp.asarray(X_TARGET)
    ref_t = cp.reference_fn(torch.tensor(x0s))
    ref_j = jax.vmap(lambda x: jax_cubic(x, xT, 42, DT))(jnp.asarray(x0s))
    np.testing.assert_allclose(ref_t.numpy(), ref_j, atol=1e-5)
    js = jax.vmap(lambda x: jax_init(jcfg, x, xT))(jnp.asarray(x0s))
    ts = gp_mpc_init(cfg, x0s, X_TARGET, device="cpu")
    assert ts.y_prev.shape == js.y_prev.shape == (4, 200)
    jcycle = jax.jit(jax.vmap(lambda s, x: jax_solve(jF, jmean, jvar, jcfg, s, x)))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    for k in range(3):
        js = js.replace(x_ref=ref_j[:, k:k + N + 1])
        ts = ts.replace(x_ref=ref_t[:, k:k + N + 1])
        sj, js = jcycle(js, xj)
        st, ts = gp_mpc_solve(tF, tmean, tvar, cfg, ts, xt)
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=1e-3, err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=1e-3, err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        xj = jax.vmap(jF)(xj, sj.u0)
        xt = tF(xt, st.u0)
    # the tightened bound on v: x_min[4] + κ·σ_k from the propagated covariance
    lo_t = V_LIM + box_tightening(st.Sigmas, 0.95)[:, :, 4]
    lo_j = V_LIM + jax.vmap(lambda S: jax_box(S, 0.95))(sj.Sigmas)[:, :, 4]
    np.testing.assert_allclose(lo_t.numpy(), lo_j, atol=1e-4)
    assert float(lo_t[:, 1:].min()) > V_LIM + 0.05  # the back-off is not idle
    on_t = (st.X_opt[:, 1:, 4] <= lo_t[:, 1:] + 2e-2).numpy()
    on_j = np.asarray(sj.X_opt[:, 1:, 4] <= lo_j[:, 1:] + 2e-2)
    assert on_t.any() and on_j.any()
    np.testing.assert_array_equal(on_t.any(axis=1), on_j.any(axis=1))  # the same lanes ride it
    # 50 iterations reject some bound-riding QPs (both packages the same
    # lanes, asserted above); an accepted lane is one that rides the bound
    assert (st.success.numpy() & on_t.any(axis=1)).any()


def test_calibration_flight_observables():
    """The fly helper on a stub GP (zero residual mean, tiny variance, so the
    known gust is the whole disturbance): the observables are finite shares,
    the gust stream comes from the generator alone (same seed, same flight),
    and the one-step coverage sits at the two-sided Gaussian target."""
    cp = calibration_path("cpu")
    mean_fn = lambda x, u: torch.zeros(*x.shape[:-1], 7)
    var_fn = with_gust_variance(lambda x, u: torch.full((*x.shape[:-1], 3), 1e-6))
    flown = []
    for _ in range(2):
        x0s = calibration_x0(torch.Generator().manual_seed(7), 6, "cpu")
        nominal = cp._replace(F_true=cp.F)  # the gust alone separates plant and model
        flown.append(fly_calibration(nominal, mean_fn, var_fn, x0s,
                                     torch.Generator().manual_seed(3), steps=30))
    obs = flown[0]
    assert obs == flown[1]
    assert obs["finite"] and obs["active_steps"] == 6 * 22  # live from step 8 on
    assert obs["kappa"] == pytest.approx(1.6449, abs=1e-3)
    for key in ("realized_violation", "realized_upper95", "binding_rate", "one_step_coverage",
                "landed_rate"):
        assert 0.0 <= obs[key] <= 1.0
    assert obs["realized_upper95"] >= obs["realized_violation"]
    # 396 draws at p = 0.90: three standard errors are 0.045
    assert abs(obs["one_step_coverage"] - 0.90) < 0.05 and obs["coverage_calibrated"]


@pytest.mark.parametrize("n_x", [7, 14])
def test_classify_touchdown_matches_jax(n_x):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, n_x)).astype(np.float32)
    x[:, 4:7] *= 1.5  # speeds on both sides of 2 m/s
    if n_x == 14:
        x[:, 7:11] /= np.linalg.norm(x[:, 7:11], axis=1, keepdims=True)
        x[::2, 7] = 1.0
        x[::2, 8:11] = 0.05 * rng.normal(size=(32, 3))  # near upright: tilt decides
        x[:, 11:14] *= 0.15
    out = classify_touchdown(torch.tensor(x), LandingCriteria())
    ref = np.asarray(jmc.classify_touchdown(jnp.asarray(x), jmc.LandingCriteria()))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert set(np.unique(ref)) == {SUCCESS, CRASH} == {jmc.SUCCESS, jmc.CRASH}


def test_wilson_interval_matches_jax():
    succ = np.array([0, 1, 5, 50, 99, 100, 0], np.float32)
    n = np.array([10, 10, 10, 100, 100, 100, 0], np.float32)
    for z in (1.96, 2.576):
        lo, hi = wilson_interval(torch.tensor(succ), torch.tensor(n), z)
        jlo, jhi = jmc.wilson_interval(jnp.asarray(succ), jnp.asarray(n), z)
        np.testing.assert_allclose(lo.numpy(), jlo, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(hi.numpy(), jhi, rtol=1e-6, atol=1e-7)
    lo, hi = wilson_interval(3.0, 40.0)
    assert lo.shape == () and 0.0 < float(lo) < 3 / 40 < float(hi) < 1.0


@pytest.mark.parametrize("n_x", [7, 14])
def test_sample_initial_conditions(n_x):
    """Shape, clipping and moments (the two packages' generators differ, so
    the draws are compared as distributions, against the JAX sampler's
    moments at the same size)."""
    sim = SimulationConfig(altitude_mean=16.0, altitude_std=1.0, mass_std=0.5)
    jsim = jmc.SimulationConfig(altitude_mean=16.0, altitude_std=1.0, mass_std=0.5)
    n = 4096
    x = sample_initial_conditions(torch.Generator().manual_seed(0), sim, n, n_x=n_x).numpy()
    ref = np.asarray(jmc.sample_initial_conditions(jax.random.PRNGKey(0), jsim, n, n_x=n_x))
    assert x.shape == ref.shape == (n, n_x)
    assert x[:, 0].min() >= sim.m_dry + 0.1 and (x[:, 0] == sim.m_dry + 0.1).any()  # clipped
    assert x[:, 1].min() >= 1.0
    # means within 5 standard errors of each other, spreads within 10%
    se = ref[:, :7].std(axis=0) * np.sqrt(2.0 / n)
    assert (np.abs(x[:, :7].mean(axis=0) - ref[:, :7].mean(axis=0)) <= 5 * se + 1e-6).all()
    np.testing.assert_allclose(x[:, :7].std(axis=0), ref[:, :7].std(axis=0), rtol=0.1)
    if n_x == 14:
        np.testing.assert_array_equal(x[:, 7:], ref[:, 7:])  # identity attitude, zero rates
    again = sample_initial_conditions(torch.Generator().manual_seed(0), sim, n, n_x=n_x)
    np.testing.assert_array_equal(again.numpy(), x)


def test_calibration_x0_starts_above_the_bound():
    x0s = calibration_x0(torch.Generator().manual_seed(7), 256, "cpu")
    assert x0s.shape == (256, 7) and float(x0s[:, 4].min()) >= V_LIM + 1.0 - 1e-6
    assert abs(float(x0s[:, 1].mean()) - 16.0) < 0.3
