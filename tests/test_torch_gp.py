"""The port's GP layer against the JAX package on the CPU: features, the
SE-ARD kernel, robust Cholesky, k-means, the FITC fit given the same data
and inducing inputs, prediction on a JAX-fitted state carried across by
``gpmpc_tpu_torch.convert``, and the exploration fit end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.gp import Simple3DoFGP as JaxGP
from gpmpc_tpu.gp import StructuredGPConfig as JaxGPConfig
from gpmpc_tpu.gp.features import AtmosphereModel as JaxAtm, simple_3dof_features as jax_feats
from gpmpc_tpu.gp.kernels import SquaredExponentialARD as JaxSE
from gpmpc_tpu.gp.sparse_gp import fit_sparse_multi as jax_fit, predict_sparse_multi as jax_predict
from gpmpc_tpu.gp.structured_gp import _stacked_kernels as jax_stacked
from gpmpc_tpu.learning import explore_gp_3dof as jax_explore
from gpmpc_tpu.ops.kmeans import kmeans as jax_kmeans
from gpmpc_tpu.ops.linalg import robust_cholesky as jax_robust_cholesky
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.gp import Simple3DoFGP, SquaredExponentialARD
from gpmpc_tpu_torch.gp.features import AtmosphereModel, simple_3dof_features
from gpmpc_tpu_torch.gp.kernels import stack_kernels
from gpmpc_tpu_torch.gp.sparse_gp import fit_sparse_multi, predict_sparse_multi
from gpmpc_tpu_torch.learning import explore_gp_3dof
from gpmpc_tpu_torch.ops.kmeans import kmeans
from gpmpc_tpu_torch.ops.linalg import cho_solve, robust_cholesky

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1


def jax_gp_to_numpy(gp) -> dict:
    """The dict ``convert.simple3dof_gp_from_numpy`` takes, from a fitted JAX
    ``Simple3DoFGP``."""
    g = gp.gp
    d = dict(
        Z=g.Z, X=g.X, Y=g.Y, mask=g.mask, log_noise=g.log_noise,
        log_lengthscales=g.kernels.log_lengthscales, log_variance=g.kernels.log_variance,
        Luu_inv=g.Luu_inv, LB_inv=g.LB_inv, c=g.c,
        buffer_X=gp.buffer.X, buffer_Y=gp.buffer.Y,
        buffer_head=gp.buffer.head, buffer_count=gp.buffer.count,
    )
    out = {k: np.asarray(v) for k, v in d.items()}
    out["method"] = g.method
    return out


def jax_explore_gp():
    """The bench's JAX GP (explore_gp_3dof with PRNGKey(0)/PRNGKey(1))."""
    jp = JaxParams()
    jpt = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    gp, _, _ = jax_explore(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jp,
                           lambda x, u: jr.step(jpt, x, u, DT), dt=DT)
    return gp


def _queries(seed=0, n=16):
    rng = np.random.default_rng(seed)
    X = (np.array([2, 20, 0.5, -0.5, -3, 0.2, 0.1]) + rng.normal(size=(n, 7)) * [0.1, 5, 1, 1, 1, 0.5, 0.5]).astype(np.float32)
    U = (np.array([2, 0, 0]) + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return X, U


def test_features_match_jax():
    X, U = _queries()
    ref = jax.vmap(lambda x, u: jax_feats(x, u, JaxAtm()))(X, U)
    out = simple_3dof_features(torch.tensor(X), torch.tensor(U), AtmosphereModel())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_se_ard_kernel_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(9, 4)).astype(np.float32)
    Z = rng.normal(size=(5, 4)).astype(np.float32)
    ll = rng.normal(size=(2, 4)).astype(np.float32) * 0.3
    lv = np.array([0.2, -0.4], np.float32)
    k = SquaredExponentialARD(log_variance=torch.tensor(lv), log_lengthscales=torch.tensor(ll))
    out = k(torch.tensor(X), torch.tensor(Z))
    for o in range(2):
        ref = JaxSE(log_variance=jnp.asarray(lv[o]), log_lengthscales=jnp.asarray(ll[o]))(X, Z)
        np.testing.assert_allclose(out[o].numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(k.diagonal(torch.tensor(X)).numpy(), np.exp(lv)[:, None].repeat(9, 1),
                               rtol=1e-6)


def test_robust_cholesky_picks_jax_jitter_level():
    rng = np.random.default_rng(2)
    G = rng.normal(size=(3, 6, 6))
    M = (G @ G.transpose(0, 2, 1)).astype(np.float32)
    M[1] = np.outer(G[1, 0], G[1, 0])  # rank one: needs jitter
    L, j = robust_cholesky(torch.tensor(M))
    for b in range(3):
        Lj, jj = jax_robust_cholesky(jnp.asarray(M[b]))
        assert float(j[b]) == pytest.approx(float(jj), rel=1e-6)
        # the rank-one lane factors M + jitter·I, conditioned ~1e8: f32
        # Cholesky implementations agree to ~1e-4 of the factor's scale
        np.testing.assert_allclose(L[b].numpy(), Lj, atol=1e-3 * float(np.abs(Lj).max()))
    rhs = torch.tensor(rng.normal(size=(3, 6, 2)), dtype=torch.float32)
    x = cho_solve(L[[0, 2]], rhs[[0, 2]])
    torch.testing.assert_close(torch.tensor(M[[0, 2]]) @ x, rhs[[0, 2]], rtol=0, atol=1e-3)


def test_kmeans_matches_jax_from_the_same_start():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    mask = np.arange(40) < 35
    key = jax.random.PRNGKey(4)
    C_j, a_j = jax_kmeans(key, jnp.asarray(X), 6, mask=jnp.asarray(mask))
    p = mask.astype(np.float32)
    idx = jax.random.choice(key, 40, (6,), replace=False, p=jnp.asarray(p / p.sum()))
    C_t, a_t = kmeans(torch.tensor(X), 6, mask=torch.tensor(mask),
                      init_idx=torch.tensor(np.asarray(idx)))
    np.testing.assert_allclose(C_t.numpy(), C_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a_t.numpy()[mask], np.asarray(a_j)[mask])


def test_kmeans_draws_from_active_points_only():
    X = torch.arange(20, dtype=torch.float32)[:, None].repeat(1, 2)
    mask = torch.arange(20) < 8
    C, assign = kmeans(X, 4, mask=mask, generator=torch.Generator().manual_seed(0))
    assert bool((C[:, 0] < 8).all())
    assert bool((assign[mask] < 4).all())


@pytest.mark.parametrize("method", ["fitc", "vfe"])
def test_sparse_fit_matches_jax_given_same_data(method):
    """Same X, Y, Z and kernels → the same factors and posterior. The
    tolerance covers two f32 Cholesky implementations on Kuu + jitter."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(30, 4)).astype(np.float32)
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1]), X[:, 2] * 0.5], axis=1).astype(np.float32)
    Z = X[::3].copy()
    mask = np.arange(30) < 27
    ls = np.full(4, 1.3, np.float32)
    jk = jax_stacked("se_ard", 4, 3, jnp.asarray(ls))
    jst = jax_fit(jk, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z), noise=1e-2,
                  mask=jnp.asarray(mask), method=method)
    tk = stack_kernels([SquaredExponentialARD.create(4, device="cpu") for _ in range(3)])
    tk.log_lengthscales = torch.log(torch.tensor(ls))[None].repeat(3, 1)
    tst = fit_sparse_multi(tk, torch.tensor(X), torch.tensor(Y), torch.tensor(Z), noise=1e-2,
                           mask=torch.tensor(mask), method=method)
    Xs = rng.normal(size=(12, 4)).astype(np.float32)
    jp = jax_predict(jst, jnp.asarray(Xs))
    tp = predict_sparse_multi(tst, torch.tensor(Xs))
    np.testing.assert_allclose(tp.mean.numpy(), jp.mean, atol=2e-4)
    np.testing.assert_allclose(tp.variance.numpy(), jp.variance, atol=2e-4)
    # c = LB⁻¹A·y reaches O(1e2) through cancellation; relative to its scale
    np.testing.assert_allclose(tst.c.numpy(), jst.c, atol=2e-3 * float(np.abs(jst.c).max()))


def test_predict_on_carried_jax_state():
    """A JAX-fitted GP carried across through NumPy predicts the same mean,
    variance and gated mean (matmuls against the same factors: a few ulps
    of the O(1) outputs)."""
    gp = jax_explore_gp()
    tgp = convert.simple3dof_gp_from_numpy(jax_gp_to_numpy(gp), device="cpu")
    X, U = _queries(7, 24)
    m_j, v_j = jax.vmap(gp.predict)(X, U)
    g_j, _ = jax.vmap(gp.predict_gated)(X, U)
    m_t, v_t = tgp.predict(torch.tensor(X), torch.tensor(U))
    g_t, _ = tgp.predict_gated(torch.tensor(X), torch.tensor(U))
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)
    # batch-first: leading (B, N) dims pass through
    m2, _ = tgp.predict(torch.tensor(X).reshape(4, 6, 7), torch.tensor(U).reshape(4, 6, 3))
    torch.testing.assert_close(m2.reshape(24, 3), m_t)
    lifted = Simple3DoFGP.lift_residual(g_t, 7)
    np.testing.assert_allclose(lifted.numpy(), jax.vmap(lambda r: JaxGP.lift_residual(r, 7))(g_j),
                               atol=1e-5)


def test_explore_fit_matches_jax_with_shared_randomness():
    """The port's explore_gp_3dof, handed the JAX run's excitation noise and
    k-means start, rebuilds the same data and a GP that predicts alike."""
    gp = jax_explore_gp()
    key_e, key_f = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key_e, k), (3,)))
                      for k in range(128)])
    idx = np.asarray(jax.random.choice(key_f, 128, (48,), replace=False,
                                       p=jnp.full(128, 1.0 / 128)))
    p = Rocket3DoFParams(device="cpu")
    pt = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    tgp, mean_fn, var_fn = explore_gp_3dof(
        None, None, p, lambda x, u: tr.step(pt, x, u, DT), dt=DT, device="cpu",
        excitation=torch.tensor(noise), init_idx=torch.tensor(idx))
    # the rollout and residuals: f32 RK4 on the same inputs
    np.testing.assert_allclose(tgp.buffer.X.numpy(), gp.buffer.X, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tgp.buffer.Y.numpy(), gp.buffer.Y, atol=2e-3)
    np.testing.assert_allclose(tgp.gp.Z.numpy(), gp.gp.Z, rtol=1e-3, atol=1e-3)
    X, U = _queries(8, 24)
    m_j, v_j = jax.vmap(gp.predict)(X, U)
    m_t, v_t = tgp.predict(torch.tensor(X), torch.tensor(U))
    # residual targets differ at the f32 level divided by dt, and the fit
    # amplifies that through c (|c| ≈ 6e2 here): means of |μ| ≤ 0.21 agree
    # to 5e-3, variances of ≤ 1 to 1e-3
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=5e-3)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-3)
    assert mean_fn(torch.tensor(X), torch.tensor(U)).shape == (24, 7)
    assert var_fn(torch.tensor(X), torch.tensor(U)).shape == (24, 3)


def test_explore_fit_with_generators_is_finite():
    p = Rocket3DoFParams(device="cpu")
    pt = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    gp, mean_fn, var_fn = explore_gp_3dof(
        torch.Generator().manual_seed(0), torch.Generator().manual_seed(1), p,
        lambda x, u: tr.step(pt, x, u, DT), dt=DT, n_points=64, n_inducing=16, device="cpu")
    X, U = _queries(9, 8)
    assert bool(torch.isfinite(mean_fn(torch.tensor(X), torch.tensor(U))).all())
    assert bool((var_fn(torch.tensor(X), torch.tensor(U)) >= 0).all())
    assert int(gp.buffer.count) == 64 and gp.gp.Z.shape == (16, 11)


def test_jax_config_fields_carry_over():
    cfg = convert._dataclass_from(type(Simple3DoFGP.create(device="cpu").config),
                                  {f: getattr(JaxGPConfig(), f) for f in ("max_data_points", "n_inducing", "noise")})
    assert (cfg.max_data_points, cfg.n_inducing, cfg.noise) == (512, 100, 1e-4)
