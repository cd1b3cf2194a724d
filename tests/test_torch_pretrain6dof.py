"""The 6-DoF GP pretraining and the Monte-Carlo campaign loop of the port
against the JAX package on the CPU: the on-policy residual collection of
``collect_residuals_6dof``, ``pretrain_gp_6dof`` end to end at a tiny size,
``run_campaign`` and ``campaign_statistics`` on a stub controller that
reaches every outcome ``run_episode`` assigns, and Path D's fleets and
flight helper. Random streams differ between the frameworks, so what the
JAX run draws from its keys is handed to the port as arrays."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxParams, rocket6dof as jr
from gpmpc_tpu.experiments import monte_carlo as jmc
from gpmpc_tpu.learning import pretrain as JP
from gpmpc_tpu_torch.dynamics import Rocket6DoFParams, rocket6dof as tr
from gpmpc_tpu_torch.experiments import (CRASH, DIVERGENCE, FUEL_EXHAUSTED, OUTCOME_NAMES,
                                         SUCCESS, TIMEOUT, LandingCriteria, SimulationConfig,
                                         campaign_statistics, run_campaign, run_episode)
from gpmpc_tpu_torch.gp import sparse_lml
from gpmpc_tpu_torch.learning import pretrain as TP
from gpmpc_tpu_torch.main_path import (fly_sixdof, sixdof_fleet_x0, sixdof_flight_x0,
                                       sixdof_path)

sys.path.insert(0, "tests")
from test_torch_pretrain import _jax_noise  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a: torch.tensor(np.asarray(a))

_JP = JaxParams()
_JPT = _JP.replace(rho=0.8, C_A=0.05 * jnp.eye(3))
_JWIND = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
_jF_true = lambda x, u: jr.step(_JPT, x, u, DT) + DT * _JWIND
_TP = Rocket6DoFParams(device="cpu")
_tF_true = sixdof_path("cpu").F_true


def _x0s():
    """Two descents that, with PRNGKey(3)'s excitation, hold no borderline
    lane. The first QPs of an episode start from the interpolated warm start
    and end near the 100-iteration limit, where a solve is accepted or
    rejected on f32 noise (in either package, and between two compilations
    of the same JAX code); in other episodes of this controller one lane in
    two flips at some step (my CPU scan of four keys and six states), and a
    rejected lane flies the fallback plan, which is a different episode."""
    return np.stack([
        np.asarray(jr.create_initial_state(_JP, altitude=17.5, velocity=(-2.6, 0.4, 0.3),
                                           horizontal=(0.8, 0.6))),
        np.asarray(jr.create_initial_state(_JP, altitude=21.0, velocity=(-2.5, -0.4, 0.1),
                                           horizontal=(-0.8, 0.3)))]).astype(np.float32)


def test_collect_residuals_6dof_matches_jax():
    """Two 6-step episodes of the nominal 6-DoF RTI controller (N = 15, the
    sparse form, n = 269, m = 493: polish, adaptive ρ, certificates) on the
    dispersed plant, from the same initial states and the same excitation
    noise. Tolerances as for the 3-DoF collector (test_torch_pretrain.py):
    the controller stops ADMM at 100 iterations short of convergence, so u
    carries the packages' f32 differences at up to 1e-2 and the closed loop
    feeds them back; the states integrate u over dt and agree ten times
    closer; the residuals are state differences over dt."""
    key = jax.random.PRNGKey(3)
    x0s = _x0s()
    Xj, Uj, Rj = JP.collect_residuals_6dof(key, _JP, _jF_true, DT, 2, 6, 0.03,
                                           x0s=jnp.asarray(x0s))
    Xt, Ut, Rt = TP.collect_residuals_6dof(None, _TP, _tF_true, DT, 2, 6, 0.03, x0s=T(x0s),
                                           noise=T(_jax_noise(key, 2, 6)), device="cpu")
    assert Xt.shape == (12, 14) and Ut.shape == (12, 3) and Rt.shape == (12, 6)
    np.testing.assert_allclose(Xt.numpy(), Xj, atol=2e-3)
    np.testing.assert_allclose(Ut.numpy(), Uj, atol=2e-2)
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=5e-3)


def test_collect_residuals_6dof_keeps_rows_after_touchdown():
    """Unlike the 3-DoF collector, the frozen rows after touchdown stay in
    the set (the JAX package's 6-DoF collector keeps them)."""
    x0s = _x0s()
    x0s[0, 1], x0s[0, 4] = 0.25, -2.0  # lands in its first step
    X, U, R = TP.collect_residuals_6dof(torch.Generator().manual_seed(0), _TP, _tF_true, DT, 2, 3,
                                        x0s=T(x0s), device="cpu")
    assert X.shape == (6, 14) and R.shape == (6, 6)
    assert float(X[1, 1]) <= 0.1 and torch.equal(X[1], X[2])  # frozen, still stored


def test_collect_residuals_6dof_needs_a_generator_or_arrays():
    with pytest.raises(ValueError, match="Generator"):
        TP.collect_residuals_6dof(None, _TP, _tF_true, device="cpu")


def test_pretrain_gp_6dof_shapes_and_lml():
    """pretrain_gp_6dof at 2 episodes × 6 steps and 3 tuning steps, every
    draw from one generator: initial states inside the documented
    distribution, both GPs fitted on all 12 transitions, the closures'
    shapes, and a finite marginal likelihood for all six outputs."""
    gp, mean_fn, var_fn = TP.pretrain_gp_6dof(torch.Generator().manual_seed(4), _TP, _tF_true,
                                              DT, 2, 6, n_inducing=8, tune_steps=3, device="cpu")
    assert int(gp.buffer_count) == 12 and gp.is_fitted
    assert gp.trans_gp.Z.shape == (8, 13) and gp.rot_gp.Z.shape == (8, 12)
    X = gp.trans_buffer.X  # features: v_I first, altitude at 11
    assert 5.0 < float(X[:, 11].min()) and float(X[:, 11].max()) <= 23.0
    x, u = T(_x0s()), torch.tensor([[2.0, 0.1, 0.0], [1.8, 0.0, -0.1]])
    assert mean_fn(x, u).shape == (2, 14) and var_fn(x, u).shape == (2, 6)
    assert bool((mean_fn(x, u)[:, [0, 1, 2, 3, 7, 8, 9, 10]] == 0).all())
    lml = torch.cat([sparse_lml(g.kernels, g.Z, g.X, g.Y, g.mask, g.log_noise, g.method)
                     for g in (gp.trans_gp, gp.rot_gp)])
    assert lml.shape == (6,) and bool(torch.isfinite(lml).all())


# -- run_episode / run_campaign / campaign_statistics ------------------------------

_SIM = dict(max_steps=30, divergence_bound=50.0)


def _campaign_x0s():
    """One lane for each outcome under hover thrust: a slow touchdown
    (SUCCESS), a fast one (CRASH), a tilted slow one (CRASH by tilt), a
    nearly dry tank (FUEL_EXHAUSTED), a lateral run past the divergence
    bound (DIVERGENCE), a hover that outlasts the episode (TIMEOUT)."""
    s = lambda **kw: np.asarray(jr.create_initial_state(_JP, **kw))
    tilt = (np.cos(np.radians(15.0)), 0.0, 0.0, np.sin(np.radians(15.0)))
    return np.stack([
        s(altitude=0.5, velocity=(-0.5, 0.0, 0.0)),
        s(altitude=1.0, velocity=(-5.0, 0.0, 0.0)),
        s(altitude=0.5, velocity=(-0.5, 0.0, 0.0), quaternion=tilt),
        s(altitude=10.0, mass=1.01),
        s(altitude=10.0, horizontal=(49.5, 0.0), velocity=(0.0, 10.0, 0.0)),
        s(altitude=20.0),
    ]).astype(np.float32)


def _stub_controllers():
    """Hover thrust, and a step counter as the controller state (frozen lanes
    must stop counting); the plant is stateful: a lateral push from its
    fourth step on."""
    jctrl = (lambda x0: jnp.zeros((), jnp.int32),
             lambda c, x, k: (jr.hover_thrust(_JP, x), c + 1))
    tctrl = (lambda x0s: torch.zeros(x0s.shape[0], dtype=torch.int32),
             lambda c, x, k: (tr.hover_thrust(_TP, x), c + 1))
    push = np.zeros(14, np.float32)
    push[6] = 0.05
    jplant = (lambda x0: jnp.zeros((), jnp.int32),
              lambda ps, x, u: (jr.step(_JP, x, u, DT) + (ps >= 3) * jnp.asarray(push), ps + 1))
    tplant = (lambda x0s: torch.zeros(x0s.shape[0], dtype=torch.int32),
              lambda ps, x, u: (tr.step(_TP, x, u, DT) + (ps >= 3)[:, None] * T(push), ps + 1))
    return jctrl, tctrl, jplant, tplant


@pytest.mark.parametrize("store", [True, False], ids=["trajectories", "outcomes"])
def test_run_campaign_matches_jax_and_reaches_every_outcome(store):
    """Every outcome code run_episode assigns (success, crash, fuel out,
    divergence, timeout), the priority order, the frozen lanes, the
    controller-state info and the statistics, against the JAX campaign:
    outcomes, steps and counts exactly, states 1e-5."""
    x0s = _campaign_x0s()
    jctrl, tctrl, jplant, tplant = _stub_controllers()
    info = {"ctrl_steps": lambda c: c}
    jsim, tsim = jmc.SimulationConfig(**_SIM), SimulationConfig(**_SIM)
    ref = jax.jit(lambda xs: jmc.run_campaign(*jctrl, jplant, xs, jsim,
                                              store_trajectories=store, cstate_info=lambda c: {
                                                  "ctrl_steps": c}))(jnp.asarray(x0s))
    out = run_campaign(*tctrl, tplant, T(x0s), tsim, store_trajectories=store,
                       cstate_info=lambda c: {"ctrl_steps": c})
    assert set(out) == set(ref) == {"outcome", "x_final", "steps", "fuel_used", "landing_speed",
                                    "landing_error", *info, *(("X", "U") if store else ())}
    np.testing.assert_array_equal(out["outcome"].numpy(), np.asarray(ref["outcome"]))
    assert out["outcome"].tolist() == [SUCCESS, CRASH, CRASH, FUEL_EXHAUSTED, DIVERGENCE, TIMEOUT]
    for k in ("steps", "ctrl_steps"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(out["steps"].numpy(), out["ctrl_steps"].numpy())
    for k in ("x_final", "fuel_used", "landing_speed", "landing_error") + (("X", "U") if store else ()):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if store:
        assert out["X"].shape == (6, 31, 14) and out["U"].shape == (6, 30, 3)
    stats, jstats = campaign_statistics(out), jmc.campaign_statistics(ref)
    assert stats["n_runs"] == jstats["n_runs"] == 6
    for k in ("success_rate", "fuel_used_mean", "fuel_used_std", "landing_speed_mean",
              "landing_error_mean", "steps_mean"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(stats["success_ci"], jstats["success_ci"]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    assert {k: int(v) for k, v in stats["outcome_counts"].items()} == {
        k: int(v) for k, v in jstats["outcome_counts"].items()}
    assert set(stats["outcome_counts"]) == set(OUTCOME_NAMES.values())


def test_run_episode_priority_and_custom_criteria():
    """A lane that is non-finite and below the pad counts as divergence
    (first in the order); a touchdown under looser criteria succeeds; a
    stateless plant and the default criteria of run_campaign."""
    x0s = T(_campaign_x0s()[:2])
    x0s[1, 5] = float("nan")
    ctrl = (lambda xs: (), lambda c, x, k: (tr.hover_thrust(_TP, x), c))
    plant = lambda x, u: tr.step(_TP, x, u, DT)
    out = run_episode(*ctrl, plant, x0s, SimulationConfig(max_steps=12), LandingCriteria())
    assert out["outcome"].tolist() == [SUCCESS, DIVERGENCE]
    assert out["steps"].tolist() == [int(out["steps"][0]), 1]
    fast = T(_campaign_x0s()[1:2])
    loose = LandingCriteria(max_landing_speed=6.0)
    assert run_episode(*ctrl, plant, fast, SimulationConfig(max_steps=5), loose)[
        "outcome"].tolist() == [SUCCESS]
    assert run_campaign(*ctrl, plant, fast, SimulationConfig(max_steps=5))[
        "outcome"].tolist() == [CRASH]


# -- Path D's fleets and flight ------------------------------------------------------


def test_sixdof_fleets():
    x0s = sixdof_fleet_x0(torch.Generator().manual_seed(7), 4096, "cpu")
    assert x0s.shape == (4096, 14)
    assert abs(float(x0s[:, 1].mean()) - 15.0) < 0.15 and abs(float(x0s[:, 1].std()) - 2.0) < 0.1
    np.testing.assert_array_equal(x0s[0, [0, 2, 3, 4, 5, 6, 7]].numpy(),
                                  np.array([2.0, 0, 0, -2.0, 0.1, 0.0, 1.0], np.float32))
    f = sixdof_flight_x0(torch.Generator().manual_seed(0), 4096, "cpu")
    assert f.shape == (4096, 14) and abs(float(f[:, 1].mean()) - 20.0) < 0.15
    assert bool((f[:, 7] == 1.0).all()) and bool((f[:, 11:] == 0).all())


def test_fly_sixdof_runs_the_campaign_loop():
    """Path D's flight helper at 2 lanes and 4 steps with a stub GP (zero
    mean, small variance): the GP-MPC controller state (a dataclass in a
    tuple with the reference) rides the campaign loop; both lanes still fly
    at the end (TIMEOUT) and the statistics say so."""
    sp = sixdof_path("cpu")
    mean_fn = lambda x, u: torch.zeros(*x.shape[:-1], 14)
    var_fn = lambda x, u: torch.full((*x.shape[:-1], 6), 1e-4)
    x0s = sixdof_flight_x0(torch.Generator().manual_seed(1), 2, "cpu")
    res, stats = fly_sixdof(sp, mean_fn, var_fn, x0s, steps=4)
    assert res["outcome"].tolist() == [TIMEOUT, TIMEOUT] and res["steps"].tolist() == [4, 4]
    assert bool((res["x_final"][:, 1] < x0s[:, 1]).all())  # descending
    assert float(stats["success_rate"]) == 0.0 and int(stats["outcome_counts"]["timeout"]) == 2
