"""The port's GP library (``gpmpc_tpu_torch/gp``) against the JAX package on
the CPU: every kernel of ``create_kernel`` and their sums and products, the
flat parameter interface, the exact GP, the fast predictors, the
single-output sparse GP with its update and Adam fit, and the lane-batched
k-means and farthest-point sampling. Inputs come from a numpy seed;
tolerances are stated per test (kernels at tests/test_gp.py's rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.gp import exact_gp as JE
from gpmpc_tpu.gp import fast_gp as JF
from gpmpc_tpu.gp import kernels as JK
from gpmpc_tpu.gp import sparse_gp as JS
from gpmpc_tpu.ops.kmeans import farthest_point_sampling as jax_fps, kmeans as jax_kmeans
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.gp import exact_gp as TE
from gpmpc_tpu_torch.gp import fast_gp as TF
from gpmpc_tpu_torch.gp import kernels as TK
from gpmpc_tpu_torch.gp import sparse_gp as TS
from gpmpc_tpu_torch.ops.kmeans import draw_active, farthest_point_sampling, kmeans

torch.set_num_threads(1)  # the suite's xdist workers share the cores

T = lambda a: torch.tensor(np.asarray(a))
NAMES = ("rbf", "se", "se_ard", "squared_exponential", "se_iso", "rbf_iso", "matern32",
         "matern_32", "matern3/2", "matern52", "matern_52", "matern5/2", "white",
         "white_noise", "noise")


def _data(seed=0, n=12, m=7, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Z = np.concatenate([X[:2], rng.normal(size=(m - 2, d))]).astype(np.float32)
    return rng, X, Z


def _pair(name, d, rng):
    """The same kernel in both packages, at random log-hyperparameters."""
    jk = JK.create_kernel(name, d)
    theta = (0.3 * rng.normal(size=jk.n_params)).astype(np.float32)
    jk = jk.set_params(jnp.asarray(theta))
    tk = TK.create_kernel(name, d, device="cpu").set_params(T(theta))
    return jk, tk


# -- kernels ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_create_kernel_every_jax_name_matches_jax(name):
    """Every name of the JAX factory builds the same kernel class at the same
    parameters: the Gram matrix (with coinciding rows, where white noise
    lives) and the diagonal at rtol 1e-5, and get_params/n_params equal."""
    rng, X, Z = _data(1)
    jk, tk = _pair(name, 3, rng)
    assert type(tk).__name__ == type(jk).__name__
    assert tk.n_params == jk.n_params
    np.testing.assert_allclose(tk.get_params().numpy(), jk.get_params(), rtol=1e-6)
    np.testing.assert_allclose(tk(T(X), T(Z)).numpy(), jk(X, Z), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tk.diagonal(T(X)).numpy(), jk.diagonal(X), rtol=1e-5)
    with pytest.raises(ValueError):
        TK.create_kernel("periodic", 3, device="cpu")


def test_kernel_defaults_and_aliases():
    """create() defaults as the JAX package's (white noise 1e-2, the rest 1);
    RBF and SE_ARD alias SE-ARD; ``variance``/``lengthscale`` pass through."""
    assert TK.RBF is TK.SE_ARD is TK.SquaredExponentialARD
    for name in ("white", "se_iso", "matern52"):
        np.testing.assert_allclose(TK.create_kernel(name, 2, device="cpu").get_params().numpy(),
                                   JK.create_kernel(name, 2).get_params(), rtol=1e-6)
    k = TK.create_kernel("matern32", 4, device="cpu", variance=2.0, lengthscale=0.5)
    j = JK.create_kernel("matern32", 4, variance=2.0, lengthscale=0.5)
    np.testing.assert_allclose(k.get_params().numpy(), j.get_params(), rtol=1e-6)


def test_sum_and_product_kernels_match_jax():
    """(SE-ARD + white) · Matérn 5/2 and SE-iso + Matérn 3/2: Gram, diagonal
    and the flat parameters (leaf order of the JAX pytree) at rtol 1e-5;
    set_params round-trips."""
    rng, X, Z = _data(2)
    (ja, ta), (jb, tb), (jc, tc) = [_pair(n, 3, rng) for n in ("se_ard", "white", "matern52")]
    (jd, td), (je, te) = [_pair(n, 3, rng) for n in ("se_iso", "matern32")]
    for jk, tk in (((ja + jb) * jc, (ta + tb) * tc), (jd + je, td + te)):
        assert type(tk).__name__ == type(jk).__name__ and tk.n_params == jk.n_params
        np.testing.assert_allclose(tk.get_params().numpy(), jk.get_params(), rtol=1e-6)
        np.testing.assert_allclose(tk(T(X), T(X)).numpy(), jk(X, X), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tk(T(X), T(Z)).numpy(), jk(X, Z), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tk.diagonal(T(X)).numpy(), jk.diagonal(X), rtol=1e-5)
        theta = tk.get_params() + 0.1
        np.testing.assert_allclose(tk.set_params(theta).get_params().numpy(), theta.numpy())


@pytest.mark.parametrize("name", ["se_iso", "matern32", "matern52", "white"])
def test_stacked_kernels_match_jax_per_output(name):
    """A stack of three kernels (``stack_kernels``) gives one Gram matrix per
    output, as the JAX package's stacked pytree under vmap."""
    rng, X, Z = _data(3)
    pairs = [_pair(name, 3, rng) for _ in range(3)]
    js = JE.stack_kernels([p[0] for p in pairs])
    ts = TK.stack_kernels([p[1] for p in pairs])
    ref = jax.vmap(lambda k: k(jnp.asarray(X), jnp.asarray(Z)))(js)
    np.testing.assert_allclose(ts(T(X), T(Z)).numpy(), ref, rtol=1e-5, atol=1e-7)
    assert ts.diagonal(T(X)).shape == (3, X.shape[0])


# -- the exact GP ----------------------------------------------------------------------


def _regression(seed=4, n=20, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2]
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    Xs = rng.normal(size=(9, d)).astype(np.float32)
    return rng, X, y, Xs


@pytest.mark.parametrize("name", ["se_ard", "matern52"])
def test_exact_gp_fit_predict_and_lml_match_jax(name):
    """Fit padded to a capacity with 3 masked rows, the posterior mean,
    variance and full covariance, ``predict_one`` and the log marginal
    likelihood, at 1e-4 of their scale; ``refit`` gives the same factors; a
    state carried across by ``convert`` predicts the same."""
    rng, X, y, Xs = _regression()
    jk, tk = _pair(name, 3, rng)
    mask = np.arange(20) < 17
    js = JE.fit(jk, X, y, noise=0.1, mask=jnp.asarray(mask), capacity=24)
    ts = TE.fit(tk, T(X), T(y), noise=0.1, mask=T(mask), capacity=24)
    assert ts.X.shape == (24, 3) and int(ts.count) == int(js.count) == 17
    jp, tp = JE.predict(js, Xs, full_cov=True), TE.predict(ts, T(Xs), full_cov=True)
    for a, b in ((tp.mean, jp.mean), (tp.variance, jp.variance), (tp.covariance, jp.covariance),
                 (tp.std, jp.std)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * float(np.abs(b).max()))
    m1, v1 = TE.predict_one(ts, T(Xs[0]))
    np.testing.assert_allclose([float(m1), float(v1)], JE.predict_one(js, Xs[0]), atol=1e-4)
    lml_j = JE.log_marginal_likelihood(jk, js.X, js.y, js.mask, js.log_noise)
    lml_t = TE.log_marginal_likelihood(tk, ts.X, ts.y, ts.mask, ts.log_noise)
    np.testing.assert_allclose(float(lml_t), float(lml_j), rtol=1e-4)
    rs = TE.refit(tk, ts.X, ts.y, ts.mask, ts.log_noise)
    torch.testing.assert_close(rs.alpha, ts.alpha)
    cs = convert.exact_gp_state_from_numpy(
        dict(X=js.X, y=js.y, mask=js.mask, log_noise=js.log_noise, L=js.L, alpha=js.alpha),
        device="cpu", kernel=tk)
    np.testing.assert_allclose(TE.predict(cs, T(Xs)).mean.numpy(), jp.mean, atol=1e-5)


def test_exact_gp_multi_output_and_hyperparameters_match_jax():
    """Three independent outputs on shared inputs (``fit_multi``,
    ``predict_multi``) at 1e-4 of the scale, and five Adam steps of
    ``optimize_hyperparameters`` from the same start: parameters within 1e-3,
    the last loss at rtol 1e-4; with ``optimize_noise=False`` the noise stays."""
    rng, X, y, Xs = _regression(5)
    Y = np.stack([y, np.cos(X[:, 1]), X[:, 0] * 0.3], 1).astype(np.float32)
    pairs = [_pair("se_ard", 3, rng) for _ in range(3)]
    js = JE.fit_multi(JE.stack_kernels([p[0] for p in pairs]), X, Y, noise=0.1, capacity=22)
    ts = TE.fit_multi(TK.stack_kernels([p[1] for p in pairs]), T(X), T(Y), noise=0.1,
                      capacity=22)
    jp, tp = JE.predict_multi(js, Xs), TE.predict_multi(ts, T(Xs))
    assert tp.mean.shape == (9, 3) and ts.n_outputs == 3
    np.testing.assert_allclose(tp.mean.numpy(), jp.mean, atol=1e-4 * float(np.abs(jp.mean).max()))
    np.testing.assert_allclose(tp.variance.numpy(), jp.variance, atol=1e-4)
    jk, tk = pairs[0]
    kj, lnj, lj = JE.optimize_hyperparameters(jk, X, y, steps=5)
    kt, lnt, lt = TE.optimize_hyperparameters(tk, T(X), T(y), steps=5)
    np.testing.assert_allclose(kt.get_params().numpy(), kj.get_params(), atol=1e-3)
    np.testing.assert_allclose(float(lnt), float(lnj), atol=1e-3)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    _, ln_fixed, _ = TE.optimize_hyperparameters(tk, T(X), T(y), steps=3, optimize_noise=False)
    assert float(ln_fixed) == pytest.approx(np.log(1e-2))


def test_exact_gp_sampling_is_generator_driven():
    """Prior draws at 3 points have the kernel's covariance (4000 draws,
    within 0.1); posterior draws sit on the posterior mean where the GP has
    data; the same generator seed gives the same draws."""
    rng, X, y, _ = _regression(6)
    _, tk = _pair("se_ard", 3, rng)
    pts = T(X[:3])
    draws = TE.sample_prior(tk, torch.Generator().manual_seed(0), pts, 4000)
    assert draws.shape == (4000, 3)
    np.testing.assert_allclose(np.cov(draws.numpy().T), tk(pts, pts).numpy(), atol=0.1)
    again = TE.sample_prior(tk, torch.Generator().manual_seed(0), pts, 4000)
    torch.testing.assert_close(draws, again)
    ts = TE.fit(tk, T(X), T(y), noise=1e-2)
    post = TE.sample_posterior(ts, torch.Generator().manual_seed(1), T(X[:4]), 200)
    np.testing.assert_allclose(post.mean(0).numpy(), TE.predict(ts, T(X[:4])).mean.numpy(),
                               atol=0.05)


# -- fast predictors -------------------------------------------------------------------


def test_fast_and_sparse_predictors_match_jax():
    """``FastGPPredictor`` (batch, one point, mean only) against the JAX
    predictor at 1e-4; ``SparseGPPredictor`` from a fitted sparse state
    against JAX's; ``create_fast_gp`` picks the sparse one when given a
    state."""
    rng, X, y, Xs = _regression(7)
    jk, tk = _pair("se_ard", 3, rng)
    jf = JF.FastGPPredictor.from_data(jk, X, y, noise=0.05)
    tf = TF.FastGPPredictor.from_data(tk, T(X), T(y), noise=0.05)
    jm, jv = jf.predict_batch(Xs)
    tm, tv = tf.predict_batch(T(Xs))
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-4 * float(np.abs(jm).max()))
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4)
    np.testing.assert_allclose(float(tf.predict_mean(T(Xs[0]))), float(jf.predict_mean(Xs[0])),
                               atol=1e-4)
    np.testing.assert_allclose([float(t) for t in tf.predict(T(Xs[1]))],
                               [float(j) for j in jf.predict(Xs[1])], atol=1e-4)
    Z = X[::3]
    js = JS.fit_sparse(jk, X, y, Z, noise=0.1)
    ts = TS.fit_sparse(tk, T(X), T(y), T(Z), noise=0.1)
    jsp, tsp = JF.create_fast_gp(jk, X, y, sparse_state=js), TF.create_fast_gp(
        tk, T(X), T(y), sparse_state=ts)
    assert isinstance(tsp, TF.SparseGPPredictor)
    assert isinstance(TF.create_fast_gp(tk, T(X), T(y)), TF.FastGPPredictor)
    jm, jv = jsp.predict_batch(Xs)
    tm, tv = tsp.predict_batch(T(Xs))
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-4 * float(np.abs(jm).max()))
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4)
    np.testing.assert_allclose(float(tsp.predict(T(Xs[2]))[0]), float(jsp.predict(Xs[2])[0]),
                               atol=1e-4)


def test_cached_predictor_hits_and_misses_as_jax():
    """The ε-ball cache over a query stream (repeats, a near repeat, a far
    point): the same values and the same hit/miss counts as the JAX cache."""
    rng, X, y, Xs = _regression(8)
    jk, tk = _pair("se_ard", 3, rng)
    jc = JF.CachedGPPredictor.create(JF.FastGPPredictor.from_data(jk, X, y), 1e-3)
    tc = TF.CachedGPPredictor.create(TF.FastGPPredictor.from_data(tk, T(X), T(y)), 1e-3)
    stream = [Xs[0], Xs[0], Xs[0] + 1e-4, Xs[1], Xs[1], Xs[0]]
    for q in stream:
        jm, jv, jc = jc.predict(jnp.asarray(q))
        tm, tv, tc = tc.predict(T(q))
        np.testing.assert_allclose([float(tm), float(tv)], [float(jm), float(jv)], atol=1e-4)
    assert (int(tc.hits), int(tc.misses)) == (int(jc.hits), int(jc.misses)) == (3, 3)
    assert float(tc.hit_rate()) == pytest.approx(float(jc.hit_rate()))


# -- the single-output sparse GP -------------------------------------------------------


@pytest.mark.parametrize("method", ["fitc", "vfe"])
def test_single_output_sparse_gp_matches_jax(method):
    """``fit_sparse`` (padded to a capacity), ``predict_sparse``, the
    single-output ``sparse_lml`` and ``refit_sparse`` at 1e-4 of the scale;
    ``update_sparse`` writes the new rows after the active ones and refits as
    JAX's does; a state carried across by ``convert`` predicts the same."""
    rng, X, y, Xs = _regression(9, n=24)
    jk, tk = _pair("matern52", 3, rng)
    Z = X[::4]
    mask = np.arange(24) < 20
    js = JS.fit_sparse(jk, X, y, Z, noise=0.1, mask=jnp.asarray(mask), capacity=30,
                       method=method)
    ts = TS.fit_sparse(tk, T(X), T(y), T(Z), noise=0.1, mask=T(mask), capacity=30,
                       method=method)
    assert ts.n_inducing == 6 and int(ts.count) == 20
    jp, tp = JS.predict_sparse(js, Xs), TS.predict_sparse(ts, T(Xs))
    np.testing.assert_allclose(tp.mean.numpy(), jp.mean, atol=1e-4 * float(np.abs(jp.mean).max()))
    np.testing.assert_allclose(tp.variance.numpy(), jp.variance, atol=1e-4)
    lj = JS.sparse_lml(jk, js.Z, js.X, js.y, js.mask, js.log_noise, method)
    lt = TS.sparse_lml(tk, ts.Z, ts.X, ts.y, ts.mask, ts.log_noise, method)
    assert lt.dim() == 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    ju = JS.update_sparse(js, Xs[:4], jnp.asarray(np.ones(4, np.float32)))
    tu = TS.update_sparse(ts, T(Xs[:4]), torch.ones(4))
    assert int(tu.count) == int(ju.count) == 24
    np.testing.assert_allclose(tu.X.numpy(), ju.X, atol=1e-7)
    np.testing.assert_allclose(TS.predict_sparse(tu, T(Xs)).mean.numpy(),
                               JS.predict_sparse(ju, Xs).mean, atol=1e-4)
    cs = convert.sparse_gp_state_from_numpy(
        dict(Z=js.Z, X=js.X, y=js.y, mask=js.mask, log_noise=js.log_noise, Luu_inv=js.Luu_inv,
             LB_inv=js.LB_inv, c=js.c, method=method), device="cpu", kernel=tk)
    np.testing.assert_allclose(TS.predict_sparse(cs, T(Xs)).mean.numpy(), jp.mean, atol=1e-5)


def test_sparse_multi_update_matches_jax():
    """``update_sparse_multi`` wraps past the capacity as JAX's does (the
    oldest rows overwritten) and refits: posterior means at 1e-4."""
    rng, X, y, Xs = _regression(10, n=16)
    Y = np.stack([y, np.cos(X[:, 0])], 1).astype(np.float32)
    pairs = [_pair("se_ard", 3, rng) for _ in range(2)]
    jk, tk = JE.stack_kernels([p[0] for p in pairs]), TK.stack_kernels([p[1] for p in pairs])
    Z = X[::4]
    js = JS.fit_sparse_multi(jk, X, Y, Z, noise=0.1, capacity=18)
    ts = TS.fit_sparse_multi(tk, T(X), T(Y), T(Z), noise=0.1, capacity=18)
    new = rng.normal(size=(5, 3)).astype(np.float32)
    newY = rng.normal(size=(5, 2)).astype(np.float32)
    ju, tu = JS.update_sparse_multi(js, new, newY), TS.update_sparse_multi(ts, T(new), T(newY))
    np.testing.assert_allclose(tu.X.numpy(), ju.X, atol=1e-7)
    np.testing.assert_array_equal(tu.mask.numpy(), np.asarray(ju.mask))
    np.testing.assert_allclose(TS.predict_sparse_multi(tu, T(Xs)).mean.numpy(),
                               JS.predict_sparse_multi(ju, Xs).mean, atol=1e-4)


@pytest.mark.parametrize("optimize_inducing", [False, True])
def test_optimize_sparse_hyperparameters_matches_jax(optimize_inducing):
    """Five Adam steps on the FITC objective, with and without the inducing
    points: kernel parameters, noise and Z within 1e-3 of JAX's, the last
    loss at rtol 1e-4."""
    rng, X, y, _ = _regression(11, n=24)
    jk, tk = _pair("se_ard", 3, rng)
    Z = X[::4]
    mask = np.ones(24, bool)
    ln = np.float32(np.log(0.1))
    kj, lnj, Zj, lj = JS.optimize_sparse_hyperparameters(
        jk, Z, X, y, mask, jnp.asarray(ln), steps=5, optimize_inducing=optimize_inducing)
    kt, lnt, Zt, lt = TS.optimize_sparse_hyperparameters(
        tk, T(Z), T(X), T(y), T(mask), T(ln), steps=5, optimize_inducing=optimize_inducing)
    np.testing.assert_allclose(kt.get_params().numpy(), kj.get_params(), atol=1e-3)
    np.testing.assert_allclose(float(lnt), float(lnj), atol=1e-3)
    np.testing.assert_allclose(Zt.numpy(), Zj, atol=1e-3)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    assert bool((Zt != T(Z)).any()) == optimize_inducing


# -- lane-batched k-means and farthest-point sampling ------------------------------------


def test_lane_batched_kmeans_matches_vmapped_jax():
    """One batched Lloyd over 5 lanes (each its own mask) from the start rows
    each lane's key draws in JAX, against ``jax.vmap(kmeans)``: centroids
    within 1e-5, assignments of active points equal; the lane axis of
    ``init_inducing_points``."""
    rng = np.random.default_rng(12)
    B, n, d, k = 5, 40, 3, 6
    X = rng.normal(size=(B, n, d)).astype(np.float32)
    mask = np.arange(n)[None] < rng.integers(20, n + 1, (B, 1))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    Cj, aj = jax.vmap(lambda kk, x, m: jax_kmeans(kk, x, k, mask=m))(keys, jnp.asarray(X),
                                                                     jnp.asarray(mask))
    idx = jax.vmap(lambda kk, m: jax.random.choice(
        kk, n, (k,), replace=False, p=m.astype(jnp.float32) / m.sum()))(keys, jnp.asarray(mask))
    Ct, at = kmeans(T(X), k, mask=T(mask), init_idx=T(idx))
    np.testing.assert_allclose(Ct.numpy(), Cj, atol=1e-5)
    np.testing.assert_array_equal(at.numpy()[mask], np.asarray(aj)[mask])
    Z = TS.init_inducing_points(T(X), k, mask=T(mask), init_idx=T(idx))
    torch.testing.assert_close(Z, Ct)


def test_kmeans_start_draws_active_rows_per_lane():
    """Drawn starts are distinct active rows of each lane; a lane with fewer
    active rows than k takes all of them first, then inactive rows in index
    order."""
    mask = torch.stack([torch.arange(10) < 8, torch.arange(10) < 3])
    idx = draw_active(mask, 5, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 5)
    assert len(set(idx[0].tolist())) == 5 and bool((idx[0] < 8).all())
    assert sorted(idx[1, :3].tolist()) == [0, 1, 2] and idx[1, 3:].tolist() == [3, 4]
    C, _ = kmeans(torch.randn(2, 10, 2, generator=torch.Generator().manual_seed(1)), 5,
                  mask=mask, generator=torch.Generator().manual_seed(2))
    assert C.shape == (2, 5, 2) and bool(torch.isfinite(C).all())


def test_farthest_point_sampling_matches_jax():
    """The same first index gives the same greedy max-min selection, masked
    rows never picked; a generator draws the first index among active rows."""
    rng = np.random.default_rng(13)
    X = rng.normal(size=(30, 4)).astype(np.float32)
    mask = np.arange(30) < 25
    key = jax.random.PRNGKey(5)
    j = np.asarray(jax_fps(key, jnp.asarray(X), 8, jnp.asarray(mask)))
    t = farthest_point_sampling(T(X), 8, T(mask), first=int(j[0]))
    np.testing.assert_array_equal(t.numpy(), j)
    g = farthest_point_sampling(T(X), 8, T(mask), generator=torch.Generator().manual_seed(0))
    assert bool((g < 25).all()) and len(set(g.tolist())) == 8
