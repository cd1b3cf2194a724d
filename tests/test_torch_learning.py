"""The port's learning helpers (``gpmpc_tpu_torch/learning``) against the JAX
package on the CPU: the hyperparameter tuner with a lane axis, MAP and
random-search tuning, the tuner facade and the adaptive scheduler; the
residuals, transition store and data manager; the novelty scores and data
selectors; and ``convert.batched_learning_config_from_fields``. Inputs come
from a numpy seed; where the JAX package draws from a key, the draw is
handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxP3, rocket3dof as jr3
from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxP6, rocket6dof as jr6
from gpmpc_tpu.gp.kernels import SquaredExponentialARD as JaxSE
from gpmpc_tpu.learning import BatchedLearningConfig as JaxBLConfig
from gpmpc_tpu.learning import data_manager as JD
from gpmpc_tpu.learning import hyperparameter_tuner as JT
from gpmpc_tpu.learning import novelty_selector as JN
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, Rocket6DoFParams
from gpmpc_tpu_torch.dynamics import rocket3dof as tr3, rocket6dof as tr6
from gpmpc_tpu_torch.gp import SquaredExponentialARD
from gpmpc_tpu_torch.learning import data_manager as TD
from gpmpc_tpu_torch.learning import hyperparameter_tuner as TT
from gpmpc_tpu_torch.learning import novelty_selector as TN
from gpmpc_tpu_torch.learning.batched_learner import BatchedLearningConfig

torch.set_num_threads(1)  # the suite's xdist workers share the cores

T = lambda a: torch.tensor(np.asarray(a))
DT = 0.1


def _problem(B, seed=0, n=36, d=4, M=9):
    """A sparse-GP tuning problem per lane: 3 outputs that depend on every
    input (so every gradient stands above f32 noise), its own mask a lane."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, d)).astype(np.float32)
    w = rng.uniform(0.3, 1.0, size=(3, d))
    Y = np.stack([np.sin(X @ w[o] + o) for o in range(3)], 1)
    Y = (Y + 0.05 * rng.normal(size=Y.shape)).astype(np.float32)
    mask = np.arange(n)[None] < rng.integers(24, n + 1, (B, 1))
    Z = X[:, ::n // M][:, :M].copy()
    ll = (0.2 * rng.normal(size=(B, 3, d))).astype(np.float32)
    lv = (0.1 * rng.normal(size=(B, 3))).astype(np.float32)
    ln = np.full((B, 3), np.log(0.1), np.float32)
    return X, Y, Z, mask, ll, lv, ln


# -- tuning ----------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [5, 10])
def test_lane_batched_tune_mle_matches_jax(steps):
    """``tune_mle`` on kernels, data and noise with a lane axis (3 lanes × 3
    outputs, one Adam run) against JAX's ``tune_mle`` under vmap over lanes
    and outputs: parameters within rtol 1e-3, the returned loss at rtol 1e-4,
    everything in the shape given."""
    X, Y, Z, mask, ll, lv, ln = _problem(3, seed=steps)
    jk = JaxSE(log_variance=jnp.asarray(lv), log_lengthscales=jnp.asarray(ll))
    cfg = JT.HyperparameterConfig(steps=steps)
    one = lambda k, y, l, z, x, m: JT.tune_mle(cfg, k, z, x, y, m, l)
    per_out = jax.vmap(one, (0, 0, 0, None, None, None))
    kj, lnj, nllj = jax.jit(jax.vmap(per_out))(jk, jnp.asarray(Y), jnp.asarray(ln),
                                               jnp.asarray(Z), jnp.asarray(X), jnp.asarray(mask))
    tk = SquaredExponentialARD(log_variance=T(lv), log_lengthscales=T(ll))
    kt, lnt, nllt = TT.tune_mle(TT.HyperparameterConfig(steps=steps), tk, T(Z), T(X), T(Y),
                                T(mask), T(ln))
    assert kt.log_lengthscales.shape == (3, 3, 4) and lnt.shape == nllt.shape == (3, 3)
    np.testing.assert_allclose(kt.log_lengthscales.numpy(), kj.log_lengthscales, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(kt.log_variance.numpy(), kj.log_variance, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(lnt.numpy(), lnj, rtol=1e-3)
    np.testing.assert_allclose(nllt.numpy(), nllj, rtol=1e-4)


def test_tune_map_single_output_matches_jax():
    """MAP on one output (unstacked kernel, scalar noise), 6 steps with a
    non-default prior: parameters within 1e-3 of JAX's ``tune_map``."""
    X, Y, Z, mask, ll, lv, ln = _problem(1, seed=3)
    jk = JaxSE(log_variance=jnp.asarray(lv[0, 0]), log_lengthscales=jnp.asarray(ll[0, 0]))
    jcfg = JT.HyperparameterConfig(steps=6, prior_mean=0.3, prior_std=0.7)
    kj, lnj, _ = JT.tune_map(jcfg, jk, Z[0], X[0], Y[0, 0], mask[0], jnp.asarray(ln[0, 0]))
    tk = SquaredExponentialARD(log_variance=T(lv[0, 0]), log_lengthscales=T(ll[0, 0]))
    kt, lnt, nllt = TT.tune_map(TT.HyperparameterConfig(steps=6, prior_mean=0.3, prior_std=0.7),
                                tk, T(Z[0]), T(X[0]), T(Y[0, 0]), T(mask[0]), T(ln[0, 0]))
    assert kt.log_variance.shape == () and nllt.shape == ()
    np.testing.assert_allclose(kt.get_params().numpy(), kj.get_params(), atol=1e-3)
    np.testing.assert_allclose(float(lnt), float(lnj), atol=1e-3)


def _jax_candidates(key, leaves, n, scale):
    """The perturbations ``tune_cv_random`` draws from ``key``, per leaf."""
    def perturb(k):
        ks = jax.random.split(k, len(leaves))
        return [scale * jax.random.normal(kk, jnp.shape(f)) for f, kk in zip(leaves, ks)]

    return [np.asarray(c) for c in jax.vmap(perturb)(jax.random.split(key, n))]


def test_tune_cv_random_matches_jax_with_its_candidates():
    """Random search with the candidates the JAX package draws from its key,
    handed to the port: the same winner (or the incumbent) and the same best
    LML at rtol 1e-4; with a generator instead, the result is no worse than
    the incumbent."""
    X, Y, Z, mask, ll, lv, ln = _problem(1, seed=4)
    jk = JaxSE(log_variance=jnp.asarray(lv[0, 0]), log_lengthscales=jnp.asarray(ll[0, 0]))
    jln = jnp.asarray(ln[0, 0])
    key = jax.random.PRNGKey(7)
    args = (Z[0], X[0], Y[0, 0], mask[0])
    kj, lnj, bj = JT.tune_cv_random(JT.HyperparameterConfig(), key, jk, *args, jln,
                                    n_candidates=12, perturb_scale=0.8)
    flat = jax.tree.leaves((jk, jln))
    cands = [T(c) for c in _jax_candidates(key, flat, 12, 0.8)]
    tk = SquaredExponentialARD(log_variance=T(lv[0, 0]), log_lengthscales=T(ll[0, 0]))
    targs = tuple(T(a) for a in args)
    kt, lnt, bt = TT.tune_cv_random(TT.HyperparameterConfig(), None, tk, *targs, T(ln[0, 0]),
                                    n_candidates=12, perturb_scale=0.8, candidates=cands)
    np.testing.assert_allclose(kt.get_params().numpy(), kj.get_params(), atol=1e-5)
    np.testing.assert_allclose(float(lnt), float(lnj), atol=1e-5)
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-4)
    from gpmpc_tpu_torch.gp import sparse_lml

    inc = float(sparse_lml(tk, *targs, T(ln[0, 0])))
    _, _, bg = TT.tune_cv_random(TT.HyperparameterConfig(), torch.Generator().manual_seed(0),
                                 tk, *targs, T(ln[0, 0]))
    assert float(bg) >= inc


def test_tuner_facade_and_scheduler_match_jax():
    """``HyperparameterTuner``: the retrain trigger and the dispatch on
    ``method`` (MLE, MAP, CV, and a ValueError otherwise) give what the
    functions give; ``AdaptiveHyperparameterScheduler`` over an error stream
    that jumps: the same averages and the same trigger steps as JAX's."""
    X, Y, Z, mask, ll, lv, ln = _problem(1, seed=5)
    tk = SquaredExponentialARD(log_variance=T(lv[0, 0]), log_lengthscales=T(ll[0, 0]))
    args = (T(Z[0]), T(X[0]), T(Y[0, 0]), T(mask[0]), T(ln[0, 0]))
    jt, tt = JT.HyperparameterTuner(), TT.HyperparameterTuner()
    assert [tt.should_retrain(e) for e in range(12)] == [jt.should_retrain(e) for e in range(12)]
    for method, fn in (("mle", TT.tune_mle), ("map", TT.tune_map)):
        cfg = TT.HyperparameterConfig(steps=3, method=method)
        k1, _, l1 = TT.HyperparameterTuner(cfg).tune(tk, *args)
        k2, _, l2 = fn(cfg, tk, *args)
        torch.testing.assert_close(k1.log_lengthscales, k2.log_lengthscales)
        torch.testing.assert_close(l1, l2)
    _, _, lcv = TT.HyperparameterTuner(TT.HyperparameterConfig(method="cv")).tune(tk, *args)
    assert bool(torch.isfinite(lcv))
    with pytest.raises(ValueError):
        TT.HyperparameterTuner(TT.HyperparameterConfig(method="bayes")).tune(tk, *args)
    errors = [0.1] * 15 + [0.5] * 6 + [0.1] * 4
    js, ts = JT.AdaptiveHyperparameterScheduler(), TT.AdaptiveHyperparameterScheduler()
    for e in errors:
        js, jtrig = js.observe(jnp.asarray(e, jnp.float32))
        ts, ttrig = ts.observe(e)
        assert ttrig == bool(jtrig)
        np.testing.assert_allclose([ts.long_avg, ts.recent_avg], [float(js.long_avg),
                                                                  float(js.recent_avg)], rtol=1e-5)
    assert ts.n == len(errors)


# -- data management -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["velocity", "acceleration", "full"])
@pytest.mark.parametrize("n_x", [7, 14])
def test_compute_residual_matches_jax(mode, n_x):
    """d = (x_next − F_nom(x, u))/dt on the learned slices (or every state),
    for both models, at 1e-4 (f32 over dt); an unknown mode raises."""
    rng = np.random.default_rng(6)
    if n_x == 7:
        jp, tp = JaxP3(), Rocket3DoFParams(device="cpu")
        jf, tf = (lambda x, u: jr3.step(jp, x, u, DT)), (lambda x, u: tr3.step(tp, x, u, DT))
        x = np.array([2.0, 20.0, 0.5, -0.5, -3.0, 0.2, 0.1]) + 0.3 * rng.normal(size=(5, 7))
    else:
        jp, tp = JaxP6(), Rocket6DoFParams(device="cpu")
        jf, tf = (lambda x, u: jr6.step(jp, x, u, DT)), (lambda x, u: tr6.step(tp, x, u, DT))
        x = np.tile(np.asarray(jr6.create_initial_state(jp, altitude=15.0)), (5, 1))
        x[:, 4:7] += 0.3 * rng.normal(size=(5, 3))
    x = x.astype(np.float32)
    u = (np.array([2.5, 0.0, 0.0]) + 0.2 * rng.normal(size=(5, 3))).astype(np.float32)
    xn = x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
    j = jax.vmap(lambda a, b, c: JD.compute_residual(jf, a, b, c, DT, mode))(x, u, xn)
    t = TD.compute_residual(tf, T(x), T(u), T(xn), DT, mode)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)
    with pytest.raises(ValueError):
        TD.compute_residual(tf, T(x), T(u), T(xn), DT, "jerk")


def test_transition_store_and_data_manager_match_jax(tmp_path):
    """A stream of transitions over three episodes into a store that wraps
    (capacity 8), one skipped by ``record=False``, episodes marked
    successful or not: every field against JAX's; ``training_mask`` by
    success and recency; ``subsample_mask`` from the scores JAX draws;
    ``.npz`` save and load."""
    rng = np.random.default_rng(7)
    jp, tp = JaxP3(), Rocket3DoFParams(device="cpu")
    jf, tf = (lambda x, u: jr3.step(jp, x, u, DT)), (lambda x, u: tr3.step(tp, x, u, DT))
    jm = JD.DataManager.create(8, 7, 3)
    tm = TD.DataManager.create(8, 7, 3, device="cpu")
    assert tm.store.R.shape == (8, 3) and TD.DataManager.create(4, 14, 3, device="cpu").store.R.shape == (4, 6)
    for ep in range(3):
        for k in range(4):
            x = (np.array([2.0, 20.0 - k, 0, 0, -3, 0, 0]) + 0.1 * rng.normal(size=7)).astype(
                np.float32)
            u = np.array([2.0, 0.1, 0.0], np.float32)
            xn = x + 0.05
            rec = not (ep == 1 and k == 2)
            jm = jm.add_transition(jf, jnp.asarray(x), jnp.asarray(u), jnp.asarray(xn), ep,
                                   record=jnp.asarray(rec))
            tm = tm.add_transition(tf, T(x), T(u), T(xn), ep, record=rec)
        jm, tm = jm.end_episode(ep, ep != 1), tm.end_episode(ep, ep != 1)
    for f in ("X", "U", "X_next", "R", "episode", "success", "head", "count"):
        np.testing.assert_allclose(getattr(tm.store, f).numpy(), np.asarray(getattr(jm.store, f)),
                                   atol=1e-4, err_msg=f)
    for kw in (dict(), dict(success_only=True), dict(recent_episodes=1, current_episode=2)):
        np.testing.assert_array_equal(tm.training_mask(**kw).numpy(),
                                      np.asarray(jm.training_mask(**kw)))
    key = jax.random.PRNGKey(2)
    m = jm.training_mask()
    scores = np.asarray(jax.random.uniform(key, m.shape))
    np.testing.assert_array_equal(
        tm.subsample_mask(None, tm.training_mask(), 4, scores=T(scores)).numpy(),
        np.asarray(jm.subsample_mask(key, m, 4)))
    drawn = tm.subsample_mask(torch.Generator().manual_seed(0), tm.training_mask(), 3)
    assert int(drawn.sum()) == 3 and bool((drawn <= tm.training_mask()).all())
    path = str(tmp_path / "dm.npz")
    tm.save(path)
    back = TD.DataManager.create(8, 7, 3, device="cpu").load(path)
    for f in ("X", "R", "episode", "success", "head", "count"):
        assert torch.equal(getattr(back.store, f), getattr(tm.store, f)), f


def test_streaming_collector_matches_jax():
    """The update flag fires every ``threshold`` accepted transitions."""
    jp, tp = JaxP3(), Rocket3DoFParams(device="cpu")
    jc = JD.StreamingDataCollector(manager=JD.DataManager.create(16, 7, 3), threshold=3)
    tc = TD.StreamingDataCollector(manager=TD.DataManager.create(16, 7, 3, device="cpu"),
                                   threshold=3)
    x = np.array([2.0, 20.0, 0, 0, -3, 0, 0], np.float32)
    u = np.array([2.0, 0.0, 0.0], np.float32)
    flags_j, flags_t = [], []
    for k in range(8):
        jc, fj = jc.collect(lambda a, b: jr3.step(jp, a, b, DT), jnp.asarray(x), jnp.asarray(u),
                            jnp.asarray(x + 0.01 * k), 0)
        tc, ft = tc.collect(lambda a, b: tr3.step(tp, a, b, DT), T(x), T(u), T(x + 0.01 * k), 0)
        flags_j.append(bool(fj))
        flags_t.append(ft)
    assert flags_t == flags_j == [False, False, True] * 2 + [False, False]
    assert int(tc.manager.store.count) == 8


# -- novelty ---------------------------------------------------------------------------


def test_novelty_scores_and_selection_match_jax():
    """Distance, variance and residual novelty and their blend against JAX at
    1e-5 (an empty reference makes everything novel); top-k and threshold
    selection; ``select_diverse`` from the same first index."""
    rng = np.random.default_rng(8)
    Xn = rng.normal(size=(12, 4)).astype(np.float32)
    Xr = rng.normal(size=(10, 4)).astype(np.float32)
    rmask = np.arange(10) < 7
    var = rng.uniform(0, 2, size=(12, 3)).astype(np.float32)
    res = rng.normal(size=(12, 3)).astype(np.float32)
    jcfg, tcfg = JN.NoveltyConfig(distance_scale=0.7), TN.NoveltyConfig(distance_scale=0.7)
    np.testing.assert_allclose(
        TN.distance_novelty(T(Xn), T(Xr), T(rmask), 0.7).numpy(),
        JN.distance_novelty(Xn, Xr, rmask, jnp.asarray(0.7)), atol=1e-5)
    empty = TN.distance_novelty(T(Xn), T(Xr), torch.zeros(10, dtype=torch.bool), 0.7)
    np.testing.assert_allclose(empty.numpy(), 1.0, atol=1e-6)
    kw = dict(variances=var, residuals=res, prior_variance=1.5, residual_scale=2.0)
    j = JN.novelty_scores(jcfg, Xn, Xr, rmask, **kw)
    t = TN.novelty_scores(tcfg, T(Xn), T(Xr), T(rmask),
                          **{k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)
    np.testing.assert_allclose(TN.variance_novelty(T(var[:, 0]), 1.5).numpy(),
                               JN.variance_novelty(var[:, 0], jnp.asarray(1.5)), atol=1e-6)
    np.testing.assert_allclose(TN.residual_novelty(T(res), 2.0).numpy(),
                               JN.residual_novelty(res, jnp.asarray(2.0)), atol=1e-6)
    sel = TN.NoveltySelector(tcfg)
    np.testing.assert_array_equal(sel.select(t, 4).numpy(), np.asarray(JN.select_top_k(j, 4)))
    np.testing.assert_array_equal(sel.select_above_threshold(t).numpy(),
                                  np.asarray(JN.NoveltySelector(jcfg).select_above_threshold(j)))
    torch.testing.assert_close(sel.scores(T(Xn), T(Xr), T(rmask)),
                               TN.novelty_scores(tcfg, T(Xn), T(Xr), T(rmask)))
    key = jax.random.PRNGKey(9)
    jd = np.asarray(JN.select_diverse(key, jnp.asarray(Xn), 5))
    td = TN.select_diverse(None, T(Xn), 5, first=int(jd[0]))
    np.testing.assert_array_equal(td.numpy(), jd)


@pytest.mark.parametrize("strategy", ["uncertainty", "ei"])
def test_active_data_selector_matches_jax(strategy):
    rng = np.random.default_rng(10)
    var = rng.uniform(0, 1, size=(15, 3)).astype(np.float32)
    res = rng.normal(size=(15, 3)).astype(np.float32)
    j = JN.ActiveDataSelector(strategy, beta=2.0).acquire(5, var, res)
    t = TN.ActiveDataSelector(strategy, beta=2.0).acquire(5, T(var), T(res))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        TN.ActiveDataSelector("greedy").acquire(5, T(var), T(res))


def test_batched_learning_config_from_jax_fields():
    """``BatchedLearningConfig`` carried across field by field (its GP config
    nested), defaults equal to the JAX package's."""
    j = JaxBLConfig()
    t = BatchedLearningConfig()
    for f in ("n_rounds", "max_steps", "dt", "landing_altitude", "success_speed",
              "min_points_for_gp", "tune_every", "tune_steps"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.gp.max_data_points, t.gp.n_inducing) == (j.gp.max_data_points, j.gp.n_inducing)
    c = convert.batched_learning_config_from_fields(dict(
        n_rounds=2, max_steps=40, tune_every=2, tune_steps=5, dt=0.1,
        gp=dict(max_data_points=64, n_inducing=12, noise=1e-3)))
    assert (c.n_rounds, c.max_steps, c.tune_every, c.gp.n_inducing, c.gp.noise) == (
        2, 40, 2, 12, 1e-3)
