"""The port's production GP fit (gpmpc_tpu_torch/learning) against the JAX
package on the CPU: the sparse marginal likelihood and its gradient, the Adam
maximum-likelihood tuner, the on-policy residual collection, and
``pretrain_gp_3dof`` end to end. Random streams differ between the
frameworks, so the initial conditions, the excitation noise and the k-means
start that the JAX run draws from its keys are handed to the port as arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.gp.sparse_gp import refit_sparse_multi as jax_refit, sparse_lml as jax_lml
from gpmpc_tpu.gp.structured_gp import _stacked_kernels as jax_stacked
from gpmpc_tpu.learning import hyperparameter_tuner as JT
from gpmpc_tpu.learning import pretrain as JP
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.gp import SquaredExponentialARD, sparse_lml
from gpmpc_tpu_torch.gp.sparse_gp import predict_sparse_multi, refit_sparse_multi
from gpmpc_tpu_torch.learning import hyperparameter_tuner as TT
from gpmpc_tpu_torch.learning import pretrain as TP

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a: torch.tensor(np.asarray(a))


def _problem(seed=0, n=40, d=4, M=10, n_out=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = np.stack([np.sin(X[:, 0]) + 0.1 * X[:, 1], np.cos(X[:, 1]), 0.5 * X[:, 2] * X[:, 3]]
                 )[:n_out].astype(np.float32)
    Y += 0.05 * rng.normal(size=Y.shape).astype(np.float32)
    mask = np.arange(n) < n - 4
    ll = (0.2 * rng.normal(size=(n_out, d))).astype(np.float32)
    lv = np.array([0.1, -0.2, 0.0], np.float32)[:n_out]
    ln = np.full(n_out, np.log(0.1), np.float32)
    return X, Y, X[::n // M][:M].copy(), mask, ll, lv, ln


def _kernels(ll, lv):
    jk = jax_stacked("se_ard", ll.shape[1], ll.shape[0]).replace(
        log_lengthscales=jnp.asarray(ll), log_variance=jnp.asarray(lv))
    return jk, SquaredExponentialARD(log_variance=T(lv), log_lengthscales=T(ll))


@pytest.mark.parametrize("method", ["fitc", "vfe"])
def test_sparse_lml_and_gradient_match_jax(method):
    """LML of every output and its gradient in the kernel parameters and the
    noise, 1e-4 relative to the largest entry (two f32 Cholesky chains)."""
    X, Y, Z, mask, ll, lv, ln = _problem()
    jk, tk = _kernels(ll, lv)

    def jloss(k, ln_):
        return jax.vmap(lambda kk, y, l: jax_lml(kk, Z, X, y, jnp.asarray(mask), l, method))(
            k, jnp.asarray(Y), ln_)

    jl = jloss(jk, jnp.asarray(ln))
    jg = jax.grad(lambda k, l: jloss(k, l).sum(), argnums=(0, 1))(jk, jnp.asarray(ln))
    leaves = [tk.log_variance.requires_grad_(), tk.log_lengthscales.requires_grad_(),
              T(ln).requires_grad_()]
    tl = sparse_lml(tk, T(Z), T(X), T(Y), T(mask), leaves[2], method)
    tl.sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-4)
    for got, ref in zip(leaves, (jg[0].log_variance, jg[0].log_lengthscales, jg[1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _jax_tune(cfg, jk, Z, X, Y, mask, ln, method="fitc"):
    one = lambda k, y, l: JT.tune_mle(cfg, k, jnp.asarray(Z), jnp.asarray(X), y,
                                      jnp.asarray(mask), l, method=method)
    return jax.jit(jax.vmap(one))(jk, jnp.asarray(Y), jnp.asarray(ln))


def test_tune_mle_five_steps_match_jax():
    """Five Adam steps from the same start: optax.adam and torch.optim.Adam
    apply the same rule (β 0.9/0.999, ε 1e-8 outside the root), every output
    with its own state, then the clip to [log_lower, log_upper]. A step is lr
    times a ratio of gradient moments, so 1e-4-relative gradients give
    parameters within 1e-3 after five steps of 0.05."""
    X, Y, Z, mask, ll, lv, ln = _problem(1)
    jk, tk = _kernels(ll, lv)
    jcfg = JT.HyperparameterConfig(steps=5)
    k_j, ln_j, nll_j = _jax_tune(jcfg, jk, Z, X, Y, mask, ln)
    k_t, ln_t, nll_t = TT.tune_mle(TT.HyperparameterConfig(steps=5), tk, T(Z), T(X), T(Y),
                                   T(mask), T(ln))
    np.testing.assert_allclose(k_t.log_lengthscales.numpy(), k_j.log_lengthscales, atol=1e-3)
    np.testing.assert_allclose(k_t.log_variance.numpy(), k_j.log_variance, atol=1e-3)
    np.testing.assert_allclose(ln_t.numpy(), ln_j, atol=1e-3)
    np.testing.assert_allclose(nll_t.numpy(), nll_j, rtol=1e-3)
    # every parameter moved by about steps × lr, as Adam's first steps do
    assert float((k_t.log_lengthscales - T(ll)).abs().max()) > 0.1


def test_tune_mle_full_run_improves_lml_and_predicts_like_jax():
    """150 f32 steps through a Cholesky do not agree bit for bit; the result
    is held by what it is for. Both tuned LMLs beat the untuned one and agree
    to 1% of their gain, and the refitted GPs predict alike: means within
    0.02 and variances within 0.02 of outputs of O(1)."""
    X, Y, Z, mask, ll, lv, ln = _problem(2)
    jk, tk = _kernels(ll, lv)
    k_j, ln_j, nll_j = _jax_tune(JT.HyperparameterConfig(), jk, Z, X, Y, mask, ln)
    k_t, ln_t, nll_t = TT.tune_mle(TT.HyperparameterConfig(), tk, T(Z), T(X), T(Y), T(mask), T(ln))
    nll0 = -sparse_lml(tk, T(Z), T(X), T(Y), T(mask), T(ln)).numpy()
    gain = nll0 - np.asarray(nll_j)
    assert (nll_t.numpy() < nll0).all() and (gain > 0).all()
    np.testing.assert_allclose(nll_t.numpy(), nll_j, atol=0.01 * gain.max())
    Xs = np.random.default_rng(9).normal(size=(20, X.shape[1])).astype(np.float32)
    from gpmpc_tpu.gp.sparse_gp import predict_sparse_multi as jax_predict
    jp = jax_predict(jax_refit(k_j, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(Y),
                               jnp.asarray(mask), ln_j), jnp.asarray(Xs))
    tp = predict_sparse_multi(refit_sparse_multi(k_t, T(Z), T(X), T(Y), T(mask), ln_t), T(Xs))
    np.testing.assert_allclose(tp.mean.numpy(), jp.mean, atol=2e-2)
    np.testing.assert_allclose(tp.variance.numpy(), jp.variance, atol=2e-2)


def test_tune_mle_single_output_and_bounds():
    """An unstacked kernel with one target vector comes back unstacked; the
    parameters stay inside [log_lower, log_upper]; zero steps return the
    start and its loss."""
    X, Y, Z, mask, ll, lv, ln = _problem(3)
    k1 = SquaredExponentialARD(log_variance=T(lv[0]), log_lengthscales=T(ll[0]))
    lo, hi = float(ll[0].min()) - 0.2, float(ll[0].max()) + 0.2
    cfg = TT.HyperparameterConfig(steps=40, log_lower=lo, log_upper=hi)
    k, ln1, nll = TT.tune_mle(cfg, k1, T(Z), T(X), T(Y[0]), T(mask), T(ln[0]))
    assert k.log_lengthscales.shape == (4,) and k.log_variance.shape == () and nll.shape == ()
    assert lo - 1e-6 <= float(k.log_lengthscales.min()) and float(k.log_lengthscales.max()) <= hi + 1e-6
    # 40 steps of 0.05 would carry a parameter 2.0 away: the clip held one back
    assert bool(((k.log_lengthscales - lo).abs() < 1e-6).any()
                or ((k.log_lengthscales - hi).abs() < 1e-6).any())
    k0, ln0, nll0 = TT.tune_mle(TT.HyperparameterConfig(steps=0), k1, T(Z), T(X), T(Y[0]),
                                T(mask), T(ln[0]))
    torch.testing.assert_close(k0.log_lengthscales, k1.log_lengthscales, rtol=0, atol=0)
    ref = -jax_lml(_kernels(ll[:1], lv[:1])[0].replace(
        log_lengthscales=jnp.asarray(ll[0]), log_variance=jnp.asarray(lv[0])),
        jnp.asarray(Z), jnp.asarray(X), jnp.asarray(Y[0]), jnp.asarray(mask), jnp.asarray(ln[0]))
    np.testing.assert_allclose(float(nll0), float(ref), rtol=1e-4)


def test_tune_never_returns_a_worse_or_non_finite_point():
    """An output whose start is already out of f32 range (NaN loss) keeps its
    start and does not disturb the others."""
    X, Y, Z, mask, ll, lv, ln = _problem(4)
    ln_bad = ln.copy()
    ln_bad[1] = np.nan
    _, tk = _kernels(ll, lv)
    k, ln_t, nll = TT.tune_mle(TT.HyperparameterConfig(steps=5), tk, T(Z), T(X), T(Y), T(mask),
                               T(ln_bad))
    torch.testing.assert_close(k.log_lengthscales[1], T(ll[1]), rtol=0, atol=0)
    assert bool(torch.isnan(ln_t[1])) and bool(torch.isfinite(ln_t[[0, 2]]).all())
    assert float((k.log_lengthscales[0] - T(ll[0])).abs().max()) > 0.1


def test_tune_map_is_not_ported():
    """MAP tuning is ported now: five steps with the log-normal prior on every
    log-hyperparameter from the same start as the JAX package's ``tune_map``
    per output; parameters within 1e-3, as the MLE steps above."""
    X, Y, Z, mask, ll, lv, ln = _problem(5)
    jk, tk = _kernels(ll, lv)
    jcfg = JT.HyperparameterConfig(steps=5, prior_mean=0.2, prior_std=0.5)
    one = lambda k, y, l: JT.tune_map(jcfg, k, jnp.asarray(Z), jnp.asarray(X), y,
                                      jnp.asarray(mask), l)
    k_j, ln_j, nll_j = jax.jit(jax.vmap(one))(jk, jnp.asarray(Y), jnp.asarray(ln))
    k_t, ln_t, nll_t = TT.tune_map(TT.HyperparameterConfig(steps=5, prior_mean=0.2,
                                                           prior_std=0.5),
                                   tk, T(Z), T(X), T(Y), T(mask), T(ln))
    np.testing.assert_allclose(k_t.log_lengthscales.numpy(), k_j.log_lengthscales, atol=1e-3)
    np.testing.assert_allclose(k_t.log_variance.numpy(), k_j.log_variance, atol=1e-3)
    np.testing.assert_allclose(ln_t.numpy(), ln_j, atol=1e-3)
    np.testing.assert_allclose(nll_t.numpy(), nll_j, rtol=1e-4)


# -- on-policy episodes and the whole fit --------------------------------------

_JP = JaxParams()
_jF_true = lambda x, u: jr.step(_JP.replace(rho=1.0, C_D=1.0, A_ref=0.1), x, u, DT)
_TPAR = Rocket3DoFParams(device="cpu")
_tF_true = lambda x, u: tr.step(_TPAR.replace(rho=1.0, C_D=1.0, A_ref=0.1), x, u, DT)
_X0S = np.array([[2.0, 27.5, 0.6, -0.4, -3.2, 0.1, -0.1],
                 [2.0, 25.0, -0.8, 0.9, -2.7, -0.2, 0.2]], np.float32)


def _jax_noise(key, n_episodes, episode_len):
    """The excitation noise JAX's _on_policy_episodes draws from ``key``."""
    keys = jax.random.split(key, n_episodes)
    return np.stack([[np.asarray(jax.random.normal(jax.random.fold_in(ek, k), (3,)))
                      for k in range(episode_len)] for ek in keys])


@pytest.mark.parametrize("excitation", [0.0, 0.05])
def test_collect_residuals_matches_jax(excitation):
    """Two 3-step episodes of the default nominal RTI controller (N = 20,
    sparse form, polish, adaptive ρ, certificates) on the dispersed plant,
    from the same initial states and the same excitation noise. Tolerance:
    the controller stops ADMM at 100 iterations, short of convergence on this
    QP, so u0 carries the two packages' f32 differences at up to the 1e-2
    level (of thrusts between 0.3 and 5) and the closed loop feeds them back;
    the states integrate u over dt = 0.1 and agree ten times closer, and the
    residuals are state differences over dt."""
    key = jax.random.PRNGKey(3)
    Xj, Uj, Rj = JP.collect_residuals_3dof(key, _JP, _jF_true, DT, 2, 3, excitation,
                                           x0s=jnp.asarray(_X0S))
    Xt, Ut, Rt = TP.collect_residuals_3dof(
        None, _TPAR, _tF_true, DT, 2, 3, excitation, x0s=T(_X0S),
        noise=T(_jax_noise(key, 2, 3)), device="cpu")
    assert Xt.shape == (6, 7) and Rt.shape == (6, 3)
    np.testing.assert_allclose(Xt.numpy(), Xj, atol=2e-3)
    np.testing.assert_allclose(Ut.numpy(), Uj, atol=2e-2)
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=5e-3)


def test_collect_residuals_drops_rows_after_touchdown():
    x0s = _X0S.copy()
    x0s[0, 1], x0s[0, 4] = 0.25, -2.0  # lands in its first step
    X, U, R = TP.collect_residuals_3dof(
        torch.Generator().manual_seed(0), _TPAR, _tF_true, DT, 2, 3, x0s=T(x0s), device="cpu")
    assert X.shape[0] == 3 + 1 and bool((X[:, 1] > 0.1).all())


def test_collect_residuals_needs_a_generator_or_arrays():
    with pytest.raises(ValueError, match="Generator"):
        TP.collect_residuals_3dof(None, _TPAR, _tF_true, device="cpu")


def test_pretrain_gp_3dof_matches_jax():
    """pretrain_gp_3dof end to end at 2 episodes × 8 steps and 20 tuning
    steps, the port handed what the JAX run draws from its key: the initial
    states, the excitation noise and the k-means start. The key is one whose
    episodes hold no borderline acceptance: the controller's polished solve,
    stopped at 100 iterations, is accepted or rejected on f32 noise for some
    initial states (in either package, and between the port's two iteration
    paths), and a rejected lane flies the fallback plan, which is a different
    episode. The features agree to 2e-3; the tuned GP is held by its
    predictions on the flown states (the residual there is ≈ 0.4 m/s² of
    drag): means within 1e-2, variances within 5e-3; and the tuned LML is no
    worse than the untuned one."""
    key = jax.random.PRNGKey(2)
    n_ep, ep_len, n = 2, 8, 16
    gp_j, mean_j, var_j = JP.pretrain_gp_3dof(key, _JP, _jF_true, DT, n_ep, ep_len, tune_steps=20)
    kc, kf = jax.random.split(key)
    x0s = np.array([2.0, 27.0, 0.0, 0.0, -3.0, 0.0, 0.0], np.float32) + np.asarray(
        jax.random.normal(jax.random.split(kc, 2)[0], (n_ep, 7))) * np.array(
            [0.0, 2.0, 1.0, 1.0, 0.4, 0.25, 0.25], np.float32)
    idx = np.asarray(jax.random.choice(kf, n, (n,), replace=False, p=jnp.full(n, 1.0 / n)))
    gp_t, mean_t, var_t = TP.pretrain_gp_3dof(
        None, _TPAR, _tF_true, DT, n_ep, ep_len, tune_steps=20, device="cpu",
        x0s=T(x0s), noise=T(_jax_noise(kc, n_ep, ep_len)), init_idx=T(idx))
    assert int(gp_t.buffer.count) == int(gp_j.buffer.count) == n
    np.testing.assert_allclose(gp_t.buffer.X.numpy(), gp_j.buffer.X, atol=2e-3)
    np.testing.assert_allclose(gp_t.buffer.Y.numpy(), gp_j.buffer.Y, atol=5e-3)
    # the buffer holds features, not states: query at the flown states
    Xs, Us, _ = JP.collect_residuals_3dof(kc, _JP, _jF_true, DT, n_ep, ep_len)
    m_j, v_j = jax.vmap(gp_j.predict)(Xs, Us)
    m_t, v_t = gp_t.predict(T(Xs), T(Us))
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-2)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=5e-3)
    np.testing.assert_allclose(mean_t(T(Xs), T(Us)).numpy(), jax.vmap(mean_j)(Xs, Us), atol=1e-2)
    assert var_t(T(Xs), T(Us)).shape == (n, 3)
    g = gp_t.gp
    untuned = gp_t.fit(init_idx=T(idx)).gp
    lml = lambda s: sparse_lml(s.kernels, s.Z, s.X, s.Y, s.mask, s.log_noise)
    assert bool((lml(g) >= lml(untuned)).all())
