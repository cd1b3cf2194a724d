"""The port's experiments layer against the JAX package's, on the same
NumPy inputs: the baselines' closed loops, the dispersion maps given the
JAX package's own draws, the statistics and the four exporters, the
ablation tables, ``summarize``/``compare_controllers``, the figures, and
the experiment suite (``scripts/run_experiments.py``) — its plant and
reference in float64, its initial-state fixture, and a short flight whose
exports the JAX package writes alike from the same results.

Tolerances: closed loops of the smooth baseline laws at 1e-4 (f32 noise
through 40 steps of feedback); maps at 1e-5 relative; the statistics and
exported text exactly.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import experiments as JE
from gpmpc_tpu.dynamics import rocket3dof as jr3
from gpmpc_tpu_torch import experiments as TE
from gpmpc_tpu_torch.dynamics import rocket3dof as tr3
from gpmpc_tpu_torch.experiments import dispersion as tdisp

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.1
CL = dict(rtol=1e-4, atol=1e-4)
MAP = dict(rtol=1e-5, atol=1e-6)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fixture_x0(n):
    return np.load(os.path.join(ROOT, "tests", "fixtures", "experiments_x0.npz"))["x0"][:n]


def _params():
    """The suite's nominal model (config/rocket_params.yaml) in both packages."""
    from gpmpc_tpu.utils import load_experiment_config as jload
    from gpmpc_tpu_torch.utils import load_experiment_config as tload

    cfg = os.path.join(ROOT, "config")
    return jload(cfg)["rocket_params"], tload(cfg, device="cpu")["rocket_params"]


# -- baselines ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["lqr", "pid", "gravity_turn", "open_loop_freefall"])
def test_baseline_closed_loop_matches_jax(name):
    jp, tp = _params()
    x0 = _fixture_x0(8)
    xT = np.zeros(7, np.float32)
    xT[0] = 2.0
    jc = JE.create_baseline_controllers(jp, jnp.asarray(xT), DT, include=(name,))[name]
    tc = TE.create_baseline_controllers(tp, torch.tensor(xT), DT, include=(name,))[name]
    sim_j = JE.SimulationConfig(max_steps=40)
    sim_t = TE.SimulationConfig(max_steps=40)
    ref = JE.run_campaign(*jc, lambda x, u: jr3.step(jp, x, u, DT), jnp.asarray(x0), sim_j,
                          store_trajectories=True)
    out = TE.run_campaign(*tc, lambda x, u: tr3.step(tp, x, u, DT), torch.tensor(x0), sim_t,
                          store_trajectories=True)
    np.testing.assert_allclose(out["U"].numpy(), np.asarray(ref["U"]), **CL)
    np.testing.assert_allclose(out["X"].numpy(), np.asarray(ref["X"]), **CL)
    np.testing.assert_array_equal(out["outcome"].numpy(), np.asarray(ref["outcome"]))


def test_open_loop_controller_holds_the_last_control():
    plan = torch.arange(6.0).reshape(2, 3)
    cinit, cstep = TE.make_open_loop_controller(plan)
    x = torch.zeros(4, 7)
    c = cinit(x)
    assert torch.equal(cstep(c, x, 0)[0], plan[0].expand(4, 3))
    assert torch.equal(cstep(c, x, 7)[0], plan[1].expand(4, 3))


# -- dispersion --------------------------------------------------------------

WIND_MODELS = [("none", tdisp.WIND_NONE), ("constant", tdisp.WIND_CONSTANT),
               ("gust", tdisp.WIND_GUST), ("dryden", tdisp.WIND_DRYDEN)]


@pytest.mark.parametrize("label,model", WIND_MODELS, ids=[w[0] for w in WIND_MODELS])
def test_wind_velocity_matches_jax_given_the_same_draw(label, model):
    rng = np.random.default_rng(0)
    speed = (0.0, 0.3, -0.2)
    jc = JE.WindConfig(model=model, speed=jnp.asarray(speed), gust_amplitude=0.4,
                       dryden_sigma=0.5)
    tc = TE.WindConfig(model=model, speed=speed, gust_amplitude=0.4, dryden_sigma=0.5)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    xi = np.stack([np.asarray(jax.random.normal(k, (3,))) for k in keys])
    t = np.linspace(0.0, 2.3, 6).astype(np.float32)
    ws = rng.normal(size=(6, 3)).astype(np.float32)
    ref = jax.vmap(lambda k, tt, w: JE.wind_velocity(jc, k, tt, w))(keys, t, ws)
    out = TE.wind_velocity(tc, torch.tensor(xi), torch.tensor(t), torch.tensor(ws))
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(np.asarray(ref[0]), (6, 3)), **MAP)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), **MAP)


def _jax_draws(key, steps):
    """The standard-normal draws the JAX dispersed plant takes from ``key``:
    the episode's (scale, misalignment) and each step's (fluctuation, ξ)."""
    k1, k2, k3 = jax.random.split(key, 3)
    init = (jax.random.normal(k1, ()), jax.random.normal(k2, (3,)))
    per_step, k = [], k3
    for _ in range(steps):
        k, kw, kf = jax.random.split(k, 3)
        per_step.append((jax.random.normal(kf, ()), jax.random.normal(kw, (3,))))
    return init, per_step


@pytest.mark.parametrize("level", ["nominal", "low", "medium", "high"])
def test_dispersed_steps_match_jax_given_its_draws(level):
    """Three steps of the dispersed plant on 5 lanes: the port's maps fed the
    numbers ``jax.random`` drew for the JAX plant."""
    jp, tp = _params()
    B, steps = 5, 3
    x0 = _fixture_x0(B)
    u = np.tile(np.array([2.2, 0.1, -0.1], np.float32), (B, 1))
    jcfg, tcfg = JE.DispersionConfig.preset(level), TE.DispersionConfig.preset(level)
    jinit, jstep = JE.make_dispersed_plant(lambda x, v: jr3.step(jp, x, v, DT), jcfg, DT)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    draws = [_jax_draws(k, steps) for k in keys]
    jd = jax.vmap(jinit)(keys)
    td = tdisp.init_dispersed_state(
        tcfg, torch.tensor(np.stack([np.asarray(d[0][0]) for d in draws])),
        torch.tensor(np.stack([np.asarray(d[0][1]) for d in draws])))
    np.testing.assert_allclose(td.thrust_scale.numpy(), np.asarray(jd.thrust_scale), **MAP)
    np.testing.assert_allclose(td.misalign.numpy(), np.asarray(jd.misalign), **MAP)
    jx, tx = jnp.asarray(x0), torch.tensor(x0)
    for s in range(steps):
        jx, jd = jax.vmap(jstep)(jd, jx, jnp.asarray(u))
        zf = torch.tensor(np.stack([np.asarray(d[1][s][0]) for d in draws]))
        xi = torch.tensor(np.stack([np.asarray(d[1][s][1]) for d in draws]))
        tx, td = tdisp.dispersed_step(lambda x, v: tr3.step(tp, x, v, DT), tcfg, td, tx,
                                      torch.tensor(u), zf, xi, DT)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **MAP)
        np.testing.assert_allclose(td.wind_state.numpy(), np.asarray(jd.wind_state), **MAP)
        np.testing.assert_array_equal(td.step.numpy(), np.asarray(jd.step))


def test_nominal_dispersion_is_a_no_op_and_the_plant_draws_from_its_generator():
    _, tp = _params()
    F = lambda x, u: tr3.step(tp, x, u, DT)
    x = torch.tensor(_fixture_x0(6))
    u = torch.tensor([[2.0, 0.1, 0.0]]).expand(6, 3)
    init, step = TE.make_dispersed_plant(F, TE.DispersionConfig.nominal(),
                                         torch.Generator().manual_seed(0))
    x1, d = step(init(x), x, u)
    assert torch.equal(x1, F(x, u)) and int(d.step[0]) == 1
    outs = []
    for _ in range(2):
        init, step = TE.make_dispersed_plant(F, TE.DispersionConfig.high(),
                                             torch.Generator().manual_seed(1))
        outs.append(step(init(x), x, u)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], F(x, u))
    dd = TE.DispersedDynamics(F, TE.DispersionConfig.medium(), torch.Generator().manual_seed(2),
                              batch=6, device="cpu")
    assert dd.step(x, u).shape == (6, 7)
    wm = TE.WindModel(TE.DispersionConfig.high().wind, torch.Generator().manual_seed(3), 6, "cpu")
    assert wm.velocity(0.0).shape == (6, 3)
    sweep = TE.run_dispersion_sweep(lambda c: c.thrust_scale_std, ("low", "high"))
    assert sweep == {"low": 0.01, "high": 0.05}


def test_dispersion_ellipse_matches_jax():
    pts = np.random.default_rng(4).normal(size=(40, 2)).astype(np.float32) * [1.0, 0.3]
    out = TE.dispersion_ellipse(torch.tensor(pts))
    ref = JE.dispersion_ellipse(jnp.asarray(pts))
    for k in ("center", "cov", "semi_axes_3sigma", "cep_50"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    # eigenvectors up to sign
    np.testing.assert_allclose(np.abs(out["axes"].numpy()), np.abs(np.asarray(ref["axes"])),
                               rtol=1e-4, atol=1e-5)


# -- analysis ----------------------------------------------------------------


@pytest.mark.parametrize("counts", [(253, 256, 202, 256), (10, 64, 10, 64), (0, 8, 8, 8),
                                    (3, 5, 0, 0)])
def test_z_test_matches_jax_exactly(counts):
    assert TE.two_proportion_z_test(*counts) == JE.two_proportion_z_test(*counts)


@pytest.mark.parametrize("seed", [0, 1])
def test_welch_t_test_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.8, 0.05, 40).astype(np.float32)
    b = rng.normal(0.78 + 0.02 * seed, 0.06, 31).astype(np.float32)
    assert TE.welch_t_test(torch.tensor(a), torch.tensor(b)) == JE.welch_t_test(a, b)


def _results(seed, n=32, success=True):
    """A campaign result with every outcome (or with no success at all)."""
    rng = np.random.default_rng(seed)
    outcome = np.arange(n) % 6 if success else 1 + np.arange(n) % 5
    return {"outcome": outcome.astype(np.int64),
            "fuel_used": rng.uniform(0.6, 0.9, n).astype(np.float32),
            "landing_speed": rng.uniform(0.5, 2.5, n).astype(np.float32),
            "landing_error": rng.uniform(0.0, 1.0, n).astype(np.float32),
            "steps": rng.integers(50, 200, n).astype(np.int32),
            "x_final": rng.normal(size=(n, 7)).astype(np.float32)}


def _tensors(res):
    return {k: torch.tensor(v) for k, v in res.items()}


def _metrics(pkg, results):
    conv = _tensors if pkg is TE else (lambda r: {k: jnp.asarray(v) for k, v in r.items()})
    return [pkg.PerformanceMetrics.from_results(name, conv(r)) for name, r in results.items()]


def test_performance_metrics_and_every_exporter_match_jax():
    results = {"gp_mpc": _results(0), "rti_mpc": _results(1), "lqr": _results(2, success=False)}
    tm, jm = _metrics(TE, results), _metrics(JE, results)
    for a, b in zip(tm, jm):
        da, db = a.__dict__, b.__dict__
        assert list(da) == list(db)
        for k in da:
            assert da[k] == db[k] or (isinstance(db[k], float) and math.isnan(db[k])
                                      and math.isnan(da[k])), k
    assert math.isnan(tm[2].landing_speed_mean)
    te, je = TE.ResultsExporter(), JE.ResultsExporter()
    for fmt in ("to_latex", "to_csv", "to_json", "to_prose"):
        assert getattr(te, fmt)(tm) == getattr(je, fmt)(jm), fmt
    assert '"landing_speed_mean": NaN' in te.to_json(tm)
    assert TE.generate_summary_report(tm) == JE.generate_summary_report(jm)
    assert TE.compute_improvement(tm[0], tm[1]) == JE.compute_improvement(jm[0], jm[1])
    ta, ja = TE.StatisticalAnalyzer(), JE.StatisticalAnalyzer()
    assert ta.compare_success(tm[0], tm[1]) == ja.compare_success(jm[0], jm[1])
    assert ta.compare_fuel(_tensors(results["gp_mpc"]), _tensors(results["rti_mpc"])) == \
        ja.compare_fuel(results["gp_mpc"], results["rti_mpc"])
    assert ta.metrics("gp_mpc", _tensors(results["gp_mpc"])) == tm[0]


def test_summarize_matches_jax():
    res = _results(3)
    t = TE.summarize(TE.campaign_statistics(_tensors(res)))
    j = JE.summarize(JE.campaign_statistics({k: jnp.asarray(v) for k, v in res.items()}))
    assert t == j


# -- ablation and compare_controllers ----------------------------------------


def _descent(params):
    """The proportional descent law of tests/test_monte_carlo.py, lanes first."""
    p = params.replace(T_min=0.0, T_max=5.0)

    def cstep(c, x, k):
        v_ref = -0.8 * torch.sqrt(x[:, 1].clamp_min(0.0))
        h = tr3.hover_thrust(params, x)
        u = torch.stack([h[:, 0] + 2.0 * (v_ref - x[:, 4]), h[:, 1] - x[:, 5] - 0.5 * x[:, 2],
                         h[:, 2] - x[:, 6] - 0.5 * x[:, 3]], dim=1)
        return tr3.clamp_thrust(p, u), c

    return (lambda x0s: x0s.new_zeros(x0s.shape[0], 0)), cstep


def _dead():
    return (lambda x0s: x0s.new_zeros(x0s.shape[0], 0),
            lambda c, x, k: (x.new_zeros(x.shape[0], 3), c))


def _ablation(pkg):
    from tests.test_monte_carlo import make_hover_descent_controller

    sim = pkg.SimulationConfig(max_steps=250, altitude_mean=12.0, altitude_std=0.5)
    x0 = JE.sample_initial_conditions(jax.random.PRNGKey(0), JE.SimulationConfig(
        max_steps=250, altitude_mean=12.0, altitude_std=0.5), 6)
    if pkg is JE:
        p = jr3.Rocket3DoFParams()
        good = make_hover_descent_controller(p)
        dead = (lambda x0: jnp.zeros(0), lambda c, x, k: (jnp.zeros(3), c))
        plant, xs = (lambda x, u: jr3.step(p, x, u, DT)), x0
    else:
        p = tr3.Rocket3DoFParams(device="cpu")
        good, dead = _descent(p), _dead()
        plant, xs = (lambda x, u: tr3.step(p, x, u, DT)), torch.tensor(np.asarray(x0))

    def factory(ctrl=True, aux=True):
        return good if (ctrl and aux) else dead

    study = pkg.AblationStudy(factory, plant, sim, components=("ctrl", "aux"))
    return study, study.run(xs), (good, dead, plant, xs, sim)


def test_ablation_study_tables_match_jax(tmp_path):
    _, tres, (good, dead, plant, xs, sim) = _ablation(TE)
    _, jres, _ = _ablation(JE)
    assert list(tres) == list(jres) == ["full", "no_ctrl", "no_aux", "no_ctrl+aux", "minimal"]
    for name in tres:
        assert tres[name].enabled == jres[name].enabled
        assert tres[name].metrics.successes == jres[name].metrics.successes
    assert TE.AblationStudy.interaction_table(tres) == JE.AblationStudy.interaction_table(jres)
    ti, ji = TE.AblationStudy.impact_table(tres), JE.AblationStudy.impact_table(jres)
    assert list(ti) == list(ji)
    for k in ti:
        assert ti[k]["success_rate_delta"] == ji[k]["success_rate_delta"]
    tex = TE.AblationStudy.to_latex_table(tres)
    assert tex.splitlines()[:8] == JE.AblationStudy.to_latex_table(jres).splitlines()[:8]
    assert "no\\_ctrl+aux" in tex
    simple = TE.run_simple_ablation(lambda: good, lambda: dead, plant, xs, sim)
    assert simple["with_gp"].success_rate > simple["without_gp"].success_rate
    sweep = TE.HyperparameterSweep(lambda gain: good if gain > 0 else dead, plant, sim)
    out = sweep.run({"gain": [0, 1]}, xs)
    assert [r["metrics"].successes for r in out] == [0, tres["full"].metrics.successes]
    TE.create_ablation_figure(tres, path=str(tmp_path / "ablation.png"))
    assert (tmp_path / "ablation.png").stat().st_size > 1000


def test_compare_controllers_summaries_match_jax():
    _, tres, (good, dead, plant, xs, sim) = _ablation(TE)
    t = TE.compare_controllers({"good": good, "dead": dead}, plant, xs, sim)
    assert list(t) == ["good", "dead"]
    assert float(t["dead"]["success_rate"]) == 0.0
    assert float(t["good"]["success_rate"]) == tres["full"].metrics.success_rate
    from tests.test_monte_carlo import make_hover_descent_controller

    p = jr3.Rocket3DoFParams()
    jsim = JE.SimulationConfig(max_steps=250, altitude_mean=12.0, altitude_std=0.5)
    j = JE.compare_controllers({"good": make_hover_descent_controller(p)},
                               lambda x, u: jr3.step(p, x, u, DT), jnp.asarray(xs.numpy()), jsim)
    # the same outcomes, touchdowns within the closed loops' f32 noise
    ts, js = TE.summarize(t["good"]).splitlines(), JE.summarize(j["good"]).splitlines()
    assert ts[:11] == js[:11]


# -- figures -----------------------------------------------------------------


def test_summary_figure_and_plots_render(tmp_path):
    res = _tensors(_results(5))
    fig = TE.create_summary_figure(res, X_example=torch.tensor(_fixture_x0(4)),
                                   path=str(tmp_path / "summary.png"))
    assert (tmp_path / "summary.png").stat().st_size > 1000 and fig is not None
    TE.TrajectoryVisualizer().plot_trajectory_3d(torch.tensor(_fixture_x0(4)))
    TE.TrajectoryVisualizer().plot_state_history(torch.tensor(_fixture_x0(4)),
                                                 torch.ones(3, 3))
    gv = TE.GPVisualizer()
    gv.plot_prediction_band(torch.arange(5.0), torch.zeros(5), torch.ones(5), torch.zeros(5))
    gv.plot_learning_curve([3.0, 2.0, 1.0])
    assert TE.publication_style()["savefig.dpi"] == 300
    assert TE.COLORS == JE.COLORS and TE.COLORBLIND_PALETTE == JE.COLORBLIND_PALETTE


def test_experiments_exports_the_jax_names():
    assert set(JE.__all__) <= set(TE.__all__)


# -- the experiment suite ----------------------------------------------------


def test_fixture_is_the_scripts_own_draw():
    """tests/fixtures/experiments_x0.npz is what scripts/run_experiments.py
    --standard --seed 0 samples, regenerated here from the JAX package with
    the script's own SimulationConfig."""
    from gpmpc_tpu.mpc import RTIConfig
    from gpmpc_tpu.utils import load_experiment_config

    cfg = load_experiment_config(os.path.join(ROOT, "config"))
    params = cfg["rocket_params"]
    rti_cfg = cfg["mpc_config"] if isinstance(cfg["mpc_config"], RTIConfig) else RTIConfig()
    sim = JE.SimulationConfig(max_steps=200, dt=rti_cfg.dt, altitude_mean=30.0,
                              altitude_std=2.0, vertical_velocity_mean=-3.0,
                              m_dry=float(params.m_dry))
    x0s = JE.sample_initial_conditions(jax.random.PRNGKey(0), sim, 256)
    np.testing.assert_array_equal(_fixture_x0(256), np.asarray(x0s, np.float32))


def test_suite_plant_and_reference_equal_the_scripts_in_float64():
    from gpmpc_tpu.reference import cubic_descent_reference as jref
    from gpmpc_tpu_torch.main_path import experiment_suite_path

    sp = experiment_suite_path(n_runs=8, device="cpu")
    x = _fixture_x0(8).astype(np.float64)
    x[:, 1] = np.linspace(0.5, 12.0, 8)  # through the downdraft
    u = np.tile(np.array([2.3, 0.2, -0.1]), (8, 1))
    with jax.enable_x64():
        jp, _ = _params()
        p_true = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
        wind = jnp.zeros(7).at[5].set(0.4).at[6].set(0.25)

        def plant(x, u):  # scripts/run_experiments.py:101-117
            d = DT * (wind + jnp.zeros(7).at[4].set(-2.0 * jax.nn.sigmoid((6.0 - x[1]) / 1.0)))
            return jr3.step(p_true, x, u, DT) + d

        ref = np.asarray(jax.vmap(plant)(jnp.asarray(x), jnp.asarray(u)))
        xT = jnp.zeros(7).at[0].set(2.0)
        rref = np.asarray(jax.vmap(lambda a: jref(a, xT, 96, DT))(jnp.asarray(x)))
    out = sp.plant(torch.tensor(x), torch.tensor(u))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    rout = sp.reference_fn(torch.tensor(x))
    np.testing.assert_allclose(rout.numpy(), rref, rtol=1e-12, atol=1e-12)
    assert sp.gp_config.base.N == 15 and sp.gp_config.scp_iterations == 2
    assert sp.gp_config.base.admm.max_iter == 100 and sp.gp_config.base.admm.scaling == 3
    assert sp.rti_config.admm.polish and not sp.rti_config.condensed
    assert sp.dispersion and sp.baselines is None and sp.n_runs == 8


def test_fly_experiments_quick_exports_match_jax_for_the_same_results(tmp_path):
    """The suite at 8 lanes, 40 steps and --quick's arms (a small GP fit):
    every file written, the verdict as the script takes it, and the exports
    equal to what the JAX package writes from the same per-lane results."""
    import json

    from gpmpc_tpu_torch.main_path import experiment_suite_path, experiments_x0, fly_experiments

    sp = experiment_suite_path(n_runs=8, preset="quick", device="cpu", max_steps=40,
                               n_episodes=2, episode_len=8, tune_steps=5)
    out = fly_experiments(sp, experiments_x0(8, "cpu"), torch.Generator().manual_seed(42),
                          str(tmp_path))
    assert [m.name for m in out["metrics"]] == ["gp_mpc", "rti_mpc", "gravity_turn", "pid"]
    files = out["files"]
    for f in ("metrics.csv", "metrics.json", "metrics.tex", "report.txt", "gp_vs_rti_z_test.json",
              "run.jsonl", "summary.png"):
        assert os.path.exists(files[f]), f
    jm = [JE.PerformanceMetrics.from_results(
        name, {k: jnp.asarray(_np(v)) for k, v in out["results"][name].items()})
        for name in ("gp_mpc", "rti_mpc", "gravity_turn", "pid")]
    je = JE.ResultsExporter()
    with open(files["metrics.csv"]) as f:
        assert f.read() == je.to_csv(jm)
    with open(files["metrics.json"]) as f:
        assert f.read() == je.to_json(jm)
    with open(files["metrics.tex"]) as f:
        assert f.read() == je.to_latex(jm)
    with open(files["report.txt"]) as f:
        assert f.read() == je.to_prose(jm)
    z = JE.two_proportion_z_test(jm[0].successes, 8, jm[1].successes, 8)
    with open(files["gp_vs_rti_z_test.json"]) as f:
        zt = json.load(f)
    assert zt == {"gp_mpc_success": jm[0].success_rate, "rti_mpc_success": jm[1].success_rate,
                  "z": round(z["z"], 3), "p_value": round(z["p_value"], 6),
                  "significant_05": bool(z["significant_05"])}
    events = [json.loads(line)["event"] for line in open(files["run.jsonl"])]
    assert events == ["start", "pretrain"] + ["campaign"] * 4 + ["done", "z_test"]
    assert out["passed"] == (jm[0].success_rate >= 0.9 and jm[0].success_rate
                             >= jm[1].success_rate)
    assert set(out["seconds"]) == {"pretrain", "gp_mpc", "rti_mpc", "gravity_turn", "pid"}
