"""Path F, fleet GP learning (``learning/batched_learner.py``), against the
JAX package on the CPU: the sparse-form (``condensed=False``) GP-MPC cycle,
the lane-batched fit and retune of the fleet's per-lane GPs, one fleet
episode of each model flown by both packages from the same per-lane GPs
(carried across by ``gpmpc_tpu_torch.convert``), and a whole
``run_batched_learning`` in both packages. Inputs come from a numpy seed;
the random streams differ between the frameworks, so the k-means starts
the JAX package draws from its keys are handed to the port as indices.

The JAX episode below is the body of ``run_batched_learning``'s
``episode`` (``gpmpc_tpu/learning/batched_learner.py``), jitted on its own
so that one short episode compiles instead of the whole scan over rounds."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxP3, rocket3dof as jr3
from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxP6, rocket6dof as jr6
from gpmpc_tpu.gp import ResidualCollector as JaxCollector, Simple3DoFGP as JaxS3
from gpmpc_tpu.gp import StructuredGPConfig as JaxGPConfig, StructuredRocketGP as JaxSGP
from gpmpc_tpu.learning import BatchedLearningConfig as JaxBLConfig
from gpmpc_tpu.learning import run_batched_learning as jax_run
from gpmpc_tpu.learning.batched_learner import _tune_lane as jax_tune_lane
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig
from gpmpc_tpu.mpc.gp_mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
from gpmpc_tpu.mpc.rti6dof import rti_config_6dof as jax_rti6
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMM
from gpmpc_tpu.reference import cubic_descent_reference as jax_cdr
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.gp import Simple3DoFGP, StructuredGPConfig, StructuredRocketGP
from gpmpc_tpu_torch.learning import BatchedLearningConfig, run_batched_learning
from gpmpc_tpu_torch.learning.batched_learner import (_gated_fns, _template_gp, _tune_lane,
                                                      fleet_episode)
from gpmpc_tpu_torch.main_path import (FLEET_LANES, fleet_learning_path, fleet_learning_x0,
                                       fleet_summary)
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
from gpmpc_tpu_torch.mpc.rti import _n_rows
from gpmpc_tpu_torch.reference import cubic_descent_reference, pad_reference

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a: torch.tensor(np.asarray(a))
CPU = torch.device("cpu")


def lanes_of(obj, B):
    """A JAX pytree broadcast to B lanes (the JAX package's vmap layout)."""
    return jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (B,) + jnp.shape(a)),
                        obj)


def jax_gp_numpy(gp) -> dict:
    """The dict ``convert.online_gp_from_numpy`` takes, from a JAX
    Simple3DoFGP or StructuredRocketGP with a lane axis."""
    blocks = ((("trans_", gp.trans_gp, gp.trans_buffer), ("rot_", gp.rot_gp, gp.rot_buffer))
              if isinstance(gp, JaxSGP) else (("", gp.gp, gp.buffer),))
    out = {}
    for prefix, g, b in blocks:
        d = dict(Z=g.Z, X=g.X, Y=g.Y, mask=g.mask, log_noise=g.log_noise,
                 log_lengthscales=g.kernels.log_lengthscales, log_variance=g.kernels.log_variance,
                 Luu_inv=g.Luu_inv, LB_inv=g.LB_inv, c=g.c, buffer_X=b.X, buffer_Y=b.Y,
                 buffer_head=b.head, buffer_count=b.count)
        out.update({prefix + k: np.asarray(v) for k, v in d.items()})
        out[prefix + "method"] = g.method
    out["config"] = {f: getattr(gp.config, f) for f in ("max_data_points", "n_inducing", "noise")}
    return out


def jax_fleet(model):
    """The JAX side of ``main_path.fleet_learning_path``: nominal step, plant,
    target and ``run_batched_learning``'s default controller."""
    if model == "3dof":
        p = JaxP3()
        pt = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
        wind = jnp.zeros(7).at[5].set(0.4).at[6].set(0.25)
        return dict(p=p, F=lambda x, u: jr3.step(p, x, u, DT),
                    plant=lambda x, u: jr3.step(pt, x, u, DT) + DT * wind,
                    xT=jnp.zeros(7).at[0].set(2.0), cls=JaxS3,
                    mpc=JaxGPMPCConfig(scp_iterations=2, tighten=False))
    p = JaxP6()
    pt = p.replace(rho=0.8, C_A=0.05 * jnp.eye(3))
    wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
    base = jax_rti6(p, N=15, dt=DT, admm=JaxADMM(
        max_iter=100, polish=False, adaptive_rho=False, scaling=3, use_pallas="off")
    ).replace(accept_pri_tol=1e-2, condensed=True)
    return dict(p=p, F=lambda x, u: jr6.step(p, x, u, DT),
                plant=lambda x, u: jr6.step(pt, x, u, DT) + DT * wind,
                xT=jr6.create_initial_state(p, altitude=0.0), cls=JaxSGP,
                mpc=JaxGPMPCConfig(base=base, scp_iterations=2, tighten=True))


def descent_data(model, B, n, seed):
    """Per-lane transitions at descent states (B, n, ·): states, controls,
    the JAX plant's residuals and a valid mask with 30..n rows a lane."""
    rng = np.random.default_rng(seed)
    jf = jax_fleet(model)
    if model == "3dof":
        X = np.stack([np.full((B, n), 2.0), rng.uniform(3, 30, (B, n)), rng.normal(0, 1, (B, n)),
                      rng.normal(0, 1, (B, n)), rng.uniform(-4, 0, (B, n)),
                      rng.normal(0, 0.5, (B, n)), rng.normal(0, 0.5, (B, n))], -1)
        U = np.stack([rng.uniform(1.5, 3.0, (B, n)), rng.normal(0, 0.3, (B, n)),
                      rng.normal(0, 0.3, (B, n))], -1)
    else:
        q = np.concatenate([np.ones((B, n, 1)), rng.normal(0, 0.03, (B, n, 3))], -1)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        X = np.concatenate([np.full((B, n, 1), 2.0), rng.uniform(3, 25, (B, n, 1)),
                            rng.normal(0, 0.5, (B, n, 2)), rng.uniform(-4, 0, (B, n, 1)),
                            rng.normal(0, 0.3, (B, n, 2)), q, rng.normal(0, 0.05, (B, n, 3))], -1)
        U = np.concatenate([rng.uniform(2.0, 4.0, (B, n, 1)), rng.normal(0, 0.1, (B, n, 2))], -1)
    X, U = X.astype(np.float32), U.astype(np.float32)
    coll = JaxCollector(dt=DT)
    R = jax.vmap(lambda x, u: coll.collect_batch(jf["F"], x, u, jax.vmap(jf["plant"])(x, u)))(
        jnp.asarray(X), jnp.asarray(U))
    valid = np.arange(n)[None, :] < rng.integers(30, n + 1, (B, 1))
    return X, U, np.asarray(R), valid


def jax_starts(model, keys, mask, M):
    """The k-means start rows each lane's ``fit(key)`` draws: (B, M), or
    the translational and the rotational draws of a structured GP."""
    def one(key, m):
        p = m.astype(jnp.float32)
        return jax.random.choice(key, m.shape[0], (M,), replace=False, p=p / p.sum())

    if model == "3dof":
        return np.asarray(jax.vmap(one)(keys, jnp.asarray(mask)))
    kt, kr = jax.vmap(jax.random.split, out_axes=1)(keys)
    m = jnp.asarray(mask)
    return np.asarray(jax.vmap(one)(kt, m)), np.asarray(jax.vmap(one)(kr, m))


@functools.lru_cache(maxsize=None)
def lane_gps(model, B, seed, noise=1e-4):
    """The same per-lane GPs in both packages (64 points, 16 inducing): data
    added, then (JAX) fitted from ``PRNGKey(seed)`` split over the lanes.
    Returns (JAX unfitted, JAX fitted, port unfitted, port k-means starts,
    the data)."""
    cfg = dict(max_data_points=64, n_inducing=16, noise=noise)
    X, U, R, valid = descent_data(model, B, 48, seed)
    jcls = jax_fleet(model)["cls"]
    jg = jax.jit(jax.vmap(lambda g, x, u, r, v: g.add_data_batch_masked(x, u, r, v)))(
        lanes_of(jcls.create(JaxGPConfig(**cfg)), B), jnp.asarray(X), jnp.asarray(U),
        jnp.asarray(R), jnp.asarray(valid))
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jfit = jax.jit(jax.vmap(lambda g, k: g.fit(k)))(jg, keys)
    tcls = Simple3DoFGP if model == "3dof" else StructuredRocketGP
    tg = tcls.create(StructuredGPConfig(**cfg), device="cpu", lanes=B).add_data_batch_masked(
        T(X), T(U), T(R), T(valid))
    count = np.asarray(jg.buffer_count)
    mask = np.arange(cfg["max_data_points"])[None, :] < count[:, None]
    return jg, jfit, tg, jax_starts(model, keys, mask, cfg["n_inducing"]), (X, U, R, valid)


def fleet_x0(model, B, seed, alt=None):
    """Initial states as ``main_path.fleet_learning_x0`` draws them, from a
    numpy seed; ``alt`` = (lo, hi) draws the altitudes from U(lo, hi)
    instead, so that a short episode's cubic reference (``max_steps − 10``
    steps) is one a lane descending at 3 m/s can fly."""
    rng = np.random.default_rng(seed)
    if model == "3dof":
        x0 = np.tile(np.array([2.0, 28.0, 0.5, -0.5, -3.0, 0.0, 0.0]), (B, 1))
        x0[:, 1] += 2.0 * rng.normal(size=B)
        x0[:, 2:4] += 0.5 * rng.normal(size=(B, 2))
    else:
        x0 = np.tile(np.asarray(jr6.create_initial_state(JaxP6(), altitude=0.0,
                                                         velocity=(-3.0, 0.0, -0.1))), (B, 1))
        x0[:, 1] = 16.0 + 5.0 * rng.uniform(size=B)
        x0[:, 5] = 0.3 * rng.normal(size=B)
    if alt is not None:
        x0[:, 1] = rng.uniform(*alt, size=B)
    return x0.astype(np.float32)


def jax_episode(model, max_steps):
    """jit(vmap(episode)) of ``run_batched_learning`` for the model's fleet;
    returns (x_final, landed, U, live, model_err) per lane."""
    jf = jax_fleet(model)
    mpc, F, plant, xT, cls = jf["mpc"], jf["F"], jf["plant"], jf["xT"], jf["cls"]
    n_x = xT.shape[0]

    def episode(gp, use_gp, x0):
        def mean_fn(x, u):
            m, _ = gp.predict_gated(x, u)
            return cls.lift_residual(jnp.where(use_gp, m, jnp.zeros_like(m)), n_x)

        def var_fn(x, u):
            v = gp.predict(x, u)[1]
            return jnp.where(use_gp, v, jnp.zeros_like(v))

        need = max_steps + mpc.base.N + 1
        Xr = jax_cdr(x0, xT, max_steps - 10, DT)
        Xr = jnp.concatenate([Xr, jnp.tile(Xr[-1:], (need - Xr.shape[0], 1))], axis=0)[:need]
        st = jax_init(mpc, x0, xT)

        def body(carry, k):
            x, st, landed = carry
            stw = st.replace(x_ref=jax.lax.dynamic_slice_in_dim(
                Xr, jnp.minimum(k, max_steps - 1), mpc.base.N + 1, axis=0))
            sol, st_new = jax_solve(F, mean_fn, var_fn, mpc, stw, x)
            x_next = plant(x, sol.u0)
            x_out = jnp.where(landed, x, x_next)
            st_out = jax.tree.map(lambda a, b: jnp.where(landed, a, b), st, st_new)
            pred = F(x, sol.u0) + DT * mean_fn(x, sol.u0)
            err = jnp.where(landed, 0.0, jnp.linalg.norm(x_next - pred))
            return (x_out, st_out, landed | (x_next[1] < 0.1)), (sol.u0, ~landed, err)

        (x_f, _, landed), (U, live, errs) = jax.lax.scan(
            body, (x0, st, jnp.asarray(False)), jnp.arange(max_steps))
        n_live = jnp.maximum(jnp.sum(live.astype(jnp.float32)), 1.0)
        return x_f, landed, U, live, jnp.sum(errs) / n_live

    return jax.jit(jax.vmap(episode))


def port_cfg(max_steps, n_rounds=1, **kw):
    return BatchedLearningConfig(n_rounds=n_rounds, max_steps=max_steps, **kw)


# -- the fleet's configuration ------------------------------------------------------


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_fleet_path_is_the_scripts_configuration(model):
    """``fleet_learning_path`` against ``run_fleet_learning_tpu.py`` and
    ``run_batched_learning``'s default controller: rounds, steps, the GP's
    size and tuning cadence, N, the QP form and row count, the ADMM options
    (but ``use_pallas``: "auto" runs the same chunk in the kernel), SCP
    iterations and tightening."""
    fp = fleet_learning_path(model, "cpu")
    jm = jax_fleet(model)["mpc"]
    c = fp.config
    assert (c.n_rounds, c.max_steps, c.tune_every, c.tune_steps) == (3, 110, 2, 40)
    assert (c.gp.max_data_points, c.gp.n_inducing) == (128, 24)
    assert FLEET_LANES[model] == {"3dof": 128, "6dof": 64}[model]
    b, jb = fp.mpc.base, jm.base
    assert (b.N, b.condensed, b.accept_pri_tol) == (jb.N, jb.condensed, jb.accept_pri_tol)
    assert (fp.mpc.scp_iterations, fp.mpc.tighten) == (jm.scp_iterations, jm.tighten)
    for f in ("max_iter", "check_interval", "polish", "adaptive_rho", "scaling", "rho"):
        assert getattr(b.admm, f) == getattr(jb.admm, f), f
    assert b.admm.use_pallas == "auto"
    assert _n_rows(b) == {"3dof": 269, "6dof": 255}[model]
    np.testing.assert_allclose(fp.x_target.numpy(), jax_fleet(model)["xT"])
    x0 = fleet_learning_x0(model, torch.Generator().manual_seed(0), 6, "cpu")
    assert x0.shape == (6, 7 if model == "3dof" else 14)


# -- the sparse GP-MPC cycle --------------------------------------------------------


@pytest.fixture(scope="module")
def gps3():
    """4 lanes of the 3-DoF fleet's GP, fitted in JAX and carried across."""
    jg, jfit, tg, idx, data = lane_gps("3dof", 4, 0)
    return jfit, convert.online_gp_from_numpy(jax_gp_numpy(jfit), device="cpu")


def test_sparse_gp_mpc_cycle_matches_jax(gps3):
    """Three cycles of the 3-DoF fleet's controller (the sparse form of
    ``RTIConfig()``: N = 15, n = 157, m = 269, 100 iterations with adaptive ρ
    and polish, two SCP iterations) at 4 lanes with each lane's GP, both on
    the JAX plant's states: u0 and X_opt within 1e-3, success equal."""
    jfit, tgp = gps3
    jf, fp = jax_fleet("3dof"), fleet_learning_path("3dof", "cpu")
    x0 = fleet_x0("3dof", 4, 1)
    mean_t, var_t = _gated_fns(tgp, torch.ones(4, dtype=torch.bool), 7)

    def jstep(gp, st, x):
        mean_fn = lambda a, b: JaxS3.lift_residual(gp.predict_gated(a, b)[0], 7)
        return jax_solve(jf["F"], mean_fn, lambda a, b: gp.predict(a, b)[1], jf["mpc"], st, x)

    jstep = jax.jit(jax.vmap(jstep))
    js = jax.vmap(lambda x: jax_init(jf["mpc"], x, jf["xT"]))(jnp.asarray(x0))
    ts = gp_mpc_init(fp.mpc, x0, fp.x_target, device="cpu")
    assert ts.y_prev.shape == (4, 269) and js.y_prev.shape == (4, 269)
    ref = np.asarray(jax.vmap(lambda x: jax_cdr(x, jf["xT"], 100, DT))(jnp.asarray(x0)))
    x = jnp.asarray(x0)
    for k in range(3):
        win = ref[:, k:k + 16]
        jsol, js = jstep(jfit, js.replace(x_ref=jnp.asarray(win)), x)
        tsol, ts = gp_mpc_solve(fp.F, mean_t, var_t, fp.mpc, ts.replace(x_ref=T(win)), T(x))
        np.testing.assert_allclose(tsol.u0.numpy(), jsol.u0, atol=1e-3)
        np.testing.assert_allclose(tsol.X_opt.numpy(), jsol.X_opt, atol=1e-3)
        np.testing.assert_array_equal(tsol.success.numpy(), np.asarray(jsol.success))
        x = jax.vmap(jf["plant"])(x, jsol.u0)


def test_sparse_gp_mpc_options_outside_the_form_raise():
    """As in the JAX package, the sparse form takes neither the IPM nor
    linearized state rows (``stage_rows_fn``); ``warm_kkt`` is ported now
    and, as in JAX, needs ``step_fn`` at init (``ValueError`` without)."""
    fp = fleet_learning_path("3dof", "cpu")
    x0 = np.zeros((1, 7), np.float32)
    rows = lambda X: (None, None, None)
    for base_kw, err in (({"solver": "ipm"}, ValueError),
                         ({"stage_rows_fn": rows, "n_stage_rows": 1}, ValueError)):
        cfg = fp.mpc.replace(base=fp.mpc.base.replace(**base_kw))
        with pytest.raises(err):
            gp_mpc_init(cfg, x0, fp.x_target, device="cpu")
    with pytest.raises(ValueError, match="step_fn"):
        gp_mpc_init(fp.mpc.replace(warm_kkt=True), x0, fp.x_target, device="cpu")
    with pytest.raises(ValueError, match="step_fn"):
        jax_init(jax_fleet("3dof")["mpc"].replace(warm_kkt=True), jnp.zeros(7),
                 jax_fleet("3dof")["xT"])


def test_sparse_gp_mpc_warm_kkt_cycle_matches_jax(gps3):
    """``GPMPCConfig.warm_kkt`` on the sparse form against JAX: three cycles
    of the 3-DoF fleet's controller at fixed ρ (adaptive ρ refactors on
    discrete decisions) with each lane's GP, both packages initialized with
    ``step_fn`` and the gated GP mean, the inverse carried across the two SCP
    iterations and the cycles: u0 and X_opt within 1e-3 as above, success
    equal, the carried inverse within 1e-4 of its scale."""
    jfit, tgp = gps3
    jf, fp = jax_fleet("3dof"), fleet_learning_path("3dof", "cpu")
    jadmm = JaxADMM(max_iter=100, polish=True, adaptive_rho=False, scaling=3, use_pallas="off")
    jcfg = jf["mpc"].replace(base=jf["mpc"].base.replace(admm=jadmm), warm_kkt=True)
    tcfg = fp.mpc.replace(base=fp.mpc.base.replace(admm=fp.mpc.base.admm.replace(
        adaptive_rho=False, scaling=3)), warm_kkt=True)
    x0 = fleet_x0("3dof", 4, 1)
    mean_t, var_t = _gated_fns(tgp, torch.ones(4, dtype=torch.bool), 7)

    def jfns(gp):
        return (lambda a, b: JaxS3.lift_residual(gp.predict_gated(a, b)[0], 7),
                lambda a, b: gp.predict(a, b)[1])

    jstep = jax.jit(jax.vmap(lambda gp, st, x: jax_solve(jf["F"], *jfns(gp), jcfg, st, x)))
    js = jax.vmap(lambda gp, x: jax_init(jcfg, x, jf["xT"], step_fn=jf["F"],
                                         gp_mean_fn=jfns(gp)[0]))(jfit, jnp.asarray(x0))
    ts = gp_mpc_init(tcfg, x0, fp.x_target, step_fn=fp.F, gp_mean_fn=mean_t, device="cpu")
    tc = convert.gp_mpc_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in ("X_lin", "U_lin", "x_ref", "rho", "y_prev",
                                                 "kkt_inv", "scal_D", "scal_E", "scal_c")},
        device="cpu")

    def close(ts):
        for b in range(4):
            ref = np.asarray(js.kkt_inv[b])
            np.testing.assert_allclose(ts.kkt_inv[b].numpy(), ref, atol=1e-4 * np.abs(ref).max())

    close(ts)
    close(tc)
    ref = np.asarray(jax.vmap(lambda x: jax_cdr(x, jf["xT"], 100, DT))(jnp.asarray(x0)))
    x = jnp.asarray(x0)
    for k in range(3):
        win = ref[:, k:k + 16]
        jsol, js = jstep(jfit, js.replace(x_ref=jnp.asarray(win)), x)
        tsol, ts = gp_mpc_solve(fp.F, mean_t, var_t, tcfg, ts.replace(x_ref=T(win)), T(x))
        np.testing.assert_allclose(tsol.u0.numpy(), jsol.u0, atol=1e-3)
        np.testing.assert_allclose(tsol.X_opt.numpy(), jsol.X_opt, atol=1e-3)
        np.testing.assert_array_equal(tsol.success.numpy(), np.asarray(jsol.success))
        close(ts)
        x = jax.vmap(jf["plant"])(x, jsol.u0)


# -- the per-lane GPs: fit, predict, retune -----------------------------------------


def as_f64(obj):
    """A (nested) dataclass of tensors with its floating tensors in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: as_f64(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_lane_batched_fit_then_predict_matches_jax(model):
    """Every lane's k-means and FITC fit in one batch, from the start rows
    each lane's ``fit(key)`` draws in JAX, then the posterior at held-out
    states: the inducing points within 1e-3 (two f32 k-means chains), and
    each package's f32 posterior held against the port's float64 fit from
    the same start. Two noise levels:

    - 0.1, where f32 lands ~1e-4 (3-DoF features, norms of O(10) in the
      distance identity) or ~1e-6 (6-DoF) of the scale from float64: the
      port's mean is held against the JAX package's within 3e-4 of its
      scale and its variance within 6e-4 (the two packages' 3-DoF
      variances lie ~2.3e-4 of the scale from float64, on opposite sides),
      and the JAX package's posterior against the port's float64 fit within
      3e-4 of the scale, so that a fault the port's f32 and float64 fits
      share shows against JAX;
    - the fleet's 1e-4, where the fit is ill-conditioned (c reaches 1e3) and
      f32 lands ~4e-2 from float64 in both packages: each package's f32
      posterior is held against the port's float64 fit — the port may land
      at most twice as far from it as the JAX package does, plus 1e-4 of
      its scale."""
    B = 3
    for noise in (0.1, 1e-4):
        jg, jfit, tg, idx, (X, U, R, valid) = lane_gps(model, B, 2, noise)
        starts = T(idx) if model == "3dof" else tuple(T(i) for i in idx)
        tfit = tg.fit(init_idx=starts)
        Zj = jfit.gp.Z if model == "3dof" else jfit.trans_gp.Z
        Zt = tfit.gp.Z if model == "3dof" else tfit.trans_gp.Z
        np.testing.assert_allclose(Zt.numpy(), Zj, rtol=1e-3, atol=1e-3)
        assert np.array_equal(tfit.buffer_count.numpy(), np.asarray(jfit.buffer_count))
        xq, uq = X[:, -6:], U[:, -6:]
        mj, vj = jax.vmap(jax.vmap(lambda g, a, b: g.predict(a, b), (None, 0, 0)))(
            jfit, jnp.asarray(xq), jnp.asarray(uq))
        mt, vt = tfit.predict(T(xq), T(uq))
        m64, v64 = as_f64(tg).fit(init_idx=starts).predict(T(xq).double(), T(uq).double())
        for t, j, r in ((mt, mj, m64), (vt, vj, v64)):
            r, j = r.numpy(), np.asarray(j)
            scale = np.abs(r).max()
            err_t, err_j = np.abs(t.numpy() - r).max(), np.abs(j - r).max()
            if noise == 0.1:
                d = np.abs(t.numpy() - j).max()
                assert d <= (3e-4 if t is mt else 6e-4) * scale, (noise, d, scale)
                assert err_j <= 3e-4 * scale, (noise, err_j, scale)
            else:
                assert err_t <= 2.0 * err_j + 1e-4 * scale, (noise, err_t, err_j)


def synthetic_state(rng, B, d, cap=48, M=12):
    """A JAX multi-output sparse GP per lane on well-posed data: d-dim
    inputs, three outputs that depend on every input, noise 0.1, so every
    hyperparameter's gradient stands far above f32 noise."""
    from gpmpc_tpu.gp.kernels import SquaredExponentialARD as JaxSE
    from gpmpc_tpu.gp.sparse_gp import refit_sparse_multi as jax_refit

    X = rng.normal(size=(B, cap, d)).astype(np.float32)
    w = rng.uniform(0.3, 1.0, size=(3, d)).astype(np.float32)
    Y = np.stack([np.sin(X @ w[o] / np.sqrt(d) + o) for o in range(3)], 1)
    Y = (Y + 0.05 * rng.normal(size=Y.shape)).astype(np.float32)
    mask = np.arange(cap)[None] < rng.integers(30, cap + 1, (B, 1))
    k = JaxSE(log_variance=jnp.asarray(0.1 * rng.normal(size=(B, 3)), jnp.float32),
              log_lengthscales=jnp.asarray(np.log(np.sqrt(d)) + 0.2 * rng.normal(size=(B, 3, d)),
                                           jnp.float32))
    ln = jnp.full((B, 3), np.log(0.1), jnp.float32)
    return jax.vmap(jax_refit)(k, jnp.asarray(X[:, ::cap // M][:, :M]), jnp.asarray(X),
                               jnp.asarray(Y), jnp.asarray(mask), ln)


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_lane_batched_tune_matches_jax(model):
    """``_tune_lane``: every lane's and output's Adam MLE retune in one batch,
    8 steps from the same state, against JAX's ``_tune_lane`` under ``vmap``
    over lanes: kernel parameters and noise within rtol 1e-3. The states are
    well posed (:func:`synthetic_state`): Adam moves every parameter by ±lr
    on its first step whatever the gradient's size, so on a fleet GP, whose
    features include near-irrelevant ones, f32 noise in a tiny gradient
    flips the step's sign in one package and not the other."""
    B = 2
    rng = np.random.default_rng(0)
    _, jfit, _, _, _ = lane_gps(model, B, 3)
    if model == "3dof":
        jg = jfit.replace(gp=synthetic_state(rng, B, 11))
    else:
        jg = jfit.replace(trans_gp=synthetic_state(rng, B, 13),
                          rot_gp=synthetic_state(rng, B, 12))
    jt = jax.jit(jax.vmap(lambda g: jax_tune_lane(g, 8)))(jg)
    tt = _tune_lane(convert.online_gp_from_numpy(jax_gp_numpy(jg), device="cpu"), 8)
    pairs = ((jt.gp, tt.gp),) if model == "3dof" else ((jt.trans_gp, tt.trans_gp),
                                                        (jt.rot_gp, tt.rot_gp))
    for j, t in pairs:
        np.testing.assert_allclose(t.kernels.log_lengthscales.numpy(), j.kernels.log_lengthscales,
                                   rtol=1e-3)
        np.testing.assert_allclose(t.kernels.log_variance.numpy(), j.kernels.log_variance,
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(t.log_noise.numpy(), j.log_noise, rtol=1e-3)
        assert t.Luu_inv.shape == (B, 3, 12, 12)
    # eight steps of 0.05 moved the parameters
    assert np.abs(np.asarray(jt.gp.kernels.log_lengthscales if model == "3dof" else
                             jt.rot_gp.kernels.log_lengthscales)
                  - np.asarray(jg.gp.kernels.log_lengthscales if model == "3dof" else
                               jg.rot_gp.kernels.log_lengthscales)).max() > 0.1


def test_template_gp_is_a_fitted_gp_per_lane():
    """The round-0 state: B copies of a GP fitted on one dummy point, with
    the lane axis everywhere and a finite posterior; the activation gate
    keeps it out of the controller (zero mean and variance)."""
    for n_x, cls in ((7, Simple3DoFGP), (14, StructuredRocketGP)):
        gp = _template_gp(StructuredGPConfig(max_data_points=32, n_inducing=8),
                          torch.Generator().manual_seed(0), n_x, 3, CPU)
        assert isinstance(gp, cls) and gp.lanes == 3 and gp.is_fitted
        assert gp.buffer_count.tolist() == [1, 1, 1]
        x = torch.zeros(3, 5, n_x)
        x[..., 0], x[..., 1] = 2.0, 8.0
        if n_x == 14:
            x[..., 7] = 1.0
        u = torch.tensor([2.0, 0.0, 0.0]).expand(3, 5, 3)
        m, v = gp.predict(x, u)
        assert bool(torch.isfinite(m).all() & torch.isfinite(v).all())
        mean_fn, var_fn = _gated_fns(gp, torch.tensor([False, True, False]), n_x)
        assert float(mean_fn(x, u)[[0, 2]].abs().max()) == 0.0
        assert float(var_fn(x, u)[[0, 2]].abs().max()) == 0.0


# -- one fleet episode ----------------------------------------------------------------


def u0_spread(fp, gp, use, x0, steps, draws=3):
    """How far the port's own first u0 of an episode moves when the measured
    states change by a relative 1e-7 (about one ulp): the f32 spread of the
    controller at that cycle."""
    mean_fn, var_fn = _gated_fns(gp, use, x0.shape[1])
    n_win = fp.mpc.base.N + 1
    ref = pad_reference(cubic_descent_reference(x0, fp.x_target, steps - 10, DT), n_win)
    st = gp_mpc_init(fp.mpc, x0, fp.x_target, device="cpu").replace(x_ref=ref[:, :n_win])
    u = gp_mpc_solve(fp.F, mean_fn, var_fn, fp.mpc, st, x0)[0].u0
    g = torch.Generator().manual_seed(0)
    return max(float((gp_mpc_solve(fp.F, mean_fn, var_fn, fp.mpc, st,
                                   x0 * (1 + 1e-7 * torch.randn(x0.shape, generator=g)))[0].u0
                      - u).abs().max()) for _ in range(draws))


@pytest.mark.parametrize("model,B,steps,alt", [("3dof", 4, 25, (2.0, 3.0)),
                                               ("6dof", 2, 20, (3.0, 4.0))])
def test_fleet_episode_matches_jax(model, B, steps, alt):
    """One episode of every lane flying with its own GP (carried across from
    JAX; lane 1's GP gated off, so it flies nominal), from altitudes its
    cubic reference of ``steps − 10`` steps can be flown from: the same
    landed flags, each lane's model error (its controller model's mean
    one-step error) within rtol 1e-2 and its touchdown speed within 0.05.

    u0: the 3-DoF controller's within 1e-3 over the first 10 live steps. The
    6-DoF controller (100 fixed-ρ iterations that do not converge, 210 dense
    state-bound rows) moves its own u0 by up to ~3e-3 under a one-ulp change
    of the measured state, so two f32 implementations part at that level and
    the closed loops then drift apart: its first u0 is held within 1e-3 or
    twice that spread, whichever is larger."""
    _, jfit, _, _, _ = lane_gps(model, B, 4)
    tgp = convert.online_gp_from_numpy(jax_gp_numpy(jfit), device="cpu")
    use = np.ones(B, bool)
    use[1] = False
    x0 = fleet_x0(model, B, 5, alt)
    x_f, landed, U, live, err = jax_episode(model, steps)(jfit, jnp.asarray(use),
                                                         jnp.asarray(x0))
    U, live = np.asarray(U), np.asarray(live)
    fp = fleet_learning_path(model, "cpu")
    ep = fleet_episode(fp.F, fp.plant, fp.mpc, tgp, T(use), T(x0), fp.x_target,
                       port_cfg(steps))
    np.testing.assert_array_equal(ep["landed"].numpy(), np.asarray(landed))
    assert bool(ep["landed"].all())
    np.testing.assert_allclose(ep["model_err"].numpy(), err, rtol=1e-2)
    np.testing.assert_allclose(ep["speed"].numpy(),
                               np.linalg.norm(np.asarray(x_f)[:, 4:7], axis=1), atol=0.05)
    du = np.abs(ep["U"].numpy()[:, :10] - U[:, :10]).max(-1) * live[:, :10]
    if model == "3dof":
        assert du.max() <= 1e-3, du
    else:
        tol = max(1e-3, 2.0 * u0_spread(fp, tgp, T(use), T(x0), steps))
        assert du[:, 0].max() <= tol, (du[:, 0], tol)
    # the loop ends once every lane has landed; the rows after a lane's
    # touchdown are frozen and carry no data
    assert ep["X"].shape[1] <= steps
    v = ep["valid"]
    assert torch.equal(v, torch.arange(v.shape[1]) < v.sum(1, keepdim=True))


# -- a whole run ----------------------------------------------------------------------


@pytest.mark.parametrize("model,B,steps", [("3dof", 4, 30), ("6dof", 2, 22)])
def test_run_batched_learning_matches_jax(model, B, steps):
    """Two rounds at a short horizon in both packages (lanes starting low
    enough to land in it, a retune after the second round): the same
    ``gp_fitted`` and landed counts, every lane's GP fitted, and the
    model-error drop on the same side of 0.5 — the learning shows in both."""
    x0 = fleet_x0(model, B, 6, alt=(5.5, 6.5) if model == "3dof" else (4.0, 5.0))
    cfg_kw = dict(n_rounds=2, max_steps=steps, tune_every=2, tune_steps=5)
    jf = jax_fleet(model)
    jout = jax_run(jax.random.PRNGKey(0), jf["p"], jf["plant"], jnp.asarray(x0),
                   JaxBLConfig(gp=JaxGPConfig(max_data_points=64, n_inducing=12), **cfg_kw))
    fp = fleet_learning_path(model, "cpu")
    tout = run_batched_learning(
        torch.Generator().manual_seed(0), fp.params, fp.plant, T(x0),
        BatchedLearningConfig(gp=StructuredGPConfig(max_data_points=64, n_inducing=12),
                              **cfg_kw), device="cpu")
    assert tout["model_err"].shape == tout["landed"].shape == (2, B)
    np.testing.assert_array_equal(tout["gp_fitted"].numpy(), np.asarray(jout["gp_fitted"]))
    assert bool(tout["gp_fitted"].all())
    np.testing.assert_array_equal(tout["landed"].sum(1).numpy(),
                                  np.asarray(jout["landed"]).sum(1))
    jme, tme = np.asarray(jout["model_err"]), tout["model_err"].numpy()
    # round 0 flies nominal in both: the same model error
    np.testing.assert_allclose(tme[0], jme[0], rtol=1e-2)
    assert (tme[1].mean() / tme[0].mean() < 0.5) == (jme[1].mean() / jme[0].mean() < 0.5)
    assert tme[1].mean() / tme[0].mean() < 0.5
    summ = fleet_summary(tout, B)
    assert summ["gp_fitted_all"] and summ["lanes_improved"] == B
    assert summ["landed_by_round"] == tout["landed"].sum(1).tolist()
    assert isinstance(tout["gps"], Simple3DoFGP if model == "3dof" else StructuredRocketGP)
    # the GP and the gate each round flew with: round 0 the template, gated off
    assert len(tout["gps_by_round"]) == 2 and tout["use_gp_by_round"].shape == (2, B)
    assert not bool(tout["use_gp_by_round"][0].any()) and bool(tout["use_gp_by_round"][1].all())
    assert int(tout["gps_by_round"][1].buffer_count.min()) >= 16
    # the median as the artifact's np.median defines it (an even count of lanes)
    np.testing.assert_allclose(summ["touchdown_speed_median_by_round"],
                               np.median(tout["touchdown_speed"].double().numpy(), 1), rtol=1e-12)
