"""The port's online-learning slice (Path E) against the JAX package on the
CPU: the lane-batched ring buffers, ``DataBuffer`` and ``OnlineGPUpdater``,
``ResidualCollector.residual``, the lane-batched sparse-GP refit and
prediction, ``init_online_gp``, the novelty test and persistence, and the
3-DoF online controller flown cycle by cycle in both packages (teacher forced
on the JAX package's flown transitions), from its start and from a JAX state
carried across by ``gpmpc_tpu_torch.convert``. Inputs come from a numpy seed
and go to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr3
from gpmpc_tpu.gp import DataBuffer as JaxDataBuffer
from gpmpc_tpu.gp import OnlineGPUpdater as JaxUpdater, OnlineUpdateConfig as JaxUpdateConfig
from gpmpc_tpu.gp import ResidualCollector as JaxCollector
from gpmpc_tpu.gp import StructuredGPConfig as JaxGPConfig, StructuredRocketGP as JaxSGP
from gpmpc_tpu.gp.kernels import SquaredExponentialARD as JaxSE
from gpmpc_tpu.gp.sparse_gp import predict_sparse_multi as jax_predict
from gpmpc_tpu.gp.sparse_gp import refit_sparse_multi as jax_refit
from gpmpc_tpu.gp.structured_gp import RingBuffer as JaxRing
from gpmpc_tpu.learning import OnlineGPMPCConfig as JaxOnlineConfig
from gpmpc_tpu.learning import carry_gp_between_episodes as jax_carry
from gpmpc_tpu.learning import make_online_gp_mpc_controller as jax_make_online
from gpmpc_tpu.learning.online_gp_mpc import _recent_Z as jax_recent_Z
from gpmpc_tpu.learning.online_gp_mpc import init_online_gp as jax_init_online_gp
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig, RTIConfig as JaxRTIConfig
from gpmpc_tpu.mpc.rti import _condensed_admm_cfg as jax_condensed_admm_cfg
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.reference import cubic_descent_reference as jax_cdr
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket6DoFParams, rocket6dof as tr6
from gpmpc_tpu_torch.experiments import SimulationConfig
from gpmpc_tpu_torch.gp import (DataBuffer, OnlineGPUpdater, OnlineUpdateConfig,
                                ResidualCollector, RingBuffer, Simple3DoFGP, StructuredGPConfig,
                                StructuredRocketGP, SquaredExponentialARD, predict_sparse_multi,
                                refit_sparse_multi, sparse_lml)
from gpmpc_tpu_torch.learning import (OnlineGPMPCConfig, OnlineGPMPCState,
                                      carry_gp_between_episodes, make_online_gp_mpc_controller,
                                      online_controller_info)
from gpmpc_tpu_torch.learning.online_gp_mpc import _recent_Z, init_online_gp
from gpmpc_tpu_torch.main_path import (fly_online, learning_trace, main_path,
                                       online_flight_path, online_path)
from gpmpc_tpu_torch.mpc import GPMPCState
from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
N = 20
T = lambda a: torch.tensor(np.asarray(a))
f32 = np.float32


def lanes_of(obj, B):
    """A JAX pytree broadcast to B lanes (the JAX package's vmap layout)."""
    return jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (B,) + jnp.shape(a)),
                        obj)


def assert_buffer(tb, jb, atol=1e-6):
    """Heads and counts exactly, stored rows within ``atol``."""
    np.testing.assert_array_equal(tb.head.numpy(), np.asarray(jb.head))
    np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
    np.testing.assert_allclose(tb.X.numpy(), jb.X, atol=atol)
    np.testing.assert_allclose(tb.Y.numpy(), jb.Y, atol=atol)


# -- stores, updater, residuals ---------------------------------------------------


def test_ring_buffer_pieces_match_jax():
    """add_if_novel (duplicates and ``accept`` rejects, per lane), add and
    add_batch_masked at 4 lanes against the JAX buffers under vmap; a
    rejected point moves neither head nor count."""
    B, cap, d, o = 4, 6, 3, 2
    rng = np.random.default_rng(0)
    jb, tb = lanes_of(JaxRing.create(cap, d, o), B), RingBuffer.create(cap, d, o, "cpu", lanes=B)
    assert tb.X.shape == (B, cap, d) and tb.head.shape == (B,) and tb.mask.shape == (B, cap)
    j_novel = jax.vmap(lambda b, x, y, a: b.add_if_novel(x, y, 0.1, accept=a))
    x_prev = None
    for step in range(9):
        x = rng.normal(size=(B, d)).astype(f32)
        y = rng.normal(size=(B, o)).astype(f32)
        if x_prev is not None and step % 3 == 2:
            x[1] = x_prev[1] + 0.01  # within the novelty distance: rejected
        accept = rng.random(B) > 0.25
        jb, jok = j_novel(jb, x, y, accept)
        tb, tok = tb.add_if_novel(T(x), T(y), 0.1, accept=T(accept))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_buffer(tb, jb)
        x_prev = x
    assert not bool(tok.all()) and int(tb.count.min()) < int(tb.count.max())
    x, y = rng.normal(size=(B, d)).astype(f32), rng.normal(size=(B, o)).astype(f32)
    jb, tb = jax.vmap(lambda b, a, c: b.add(a, c))(jb, x, y), tb.add(T(x), T(y))
    assert_buffer(tb, jb)
    # at most cap valid rows, so no two valid rows share a slot
    Xb = rng.normal(size=(B, 8, d)).astype(f32)
    Yb = rng.normal(size=(B, 8, o)).astype(f32)
    valid = rng.random((B, 8)) > 0.4
    valid[0] = [True] * 6 + [False] * 2
    valid[3] = False
    jb = jax.vmap(lambda b, a, c, v: b.add_batch_masked(a, c, v))(jb, Xb, Yb, valid)
    tb = tb.add_batch_masked(T(Xb), T(Yb), T(valid))
    assert_buffer(tb, jb)
    # the single store keeps its unbatched layout
    j1 = JaxRing.create(cap, d, o).add_batch_masked(Xb[1], Yb[1], valid[1])
    t1 = RingBuffer.create(cap, d, o, "cpu").add_batch_masked(T(Xb[1]), T(Yb[1]), T(valid[1]))
    assert t1.head.shape == () and t1.mask.shape == (cap,)
    assert_buffer(t1, j1)


def test_add_batch_masked_equals_sequential_adds_beyond_capacity():
    """More valid rows than slots: the store ends as a sequential add of the
    valid rows leaves it (the later row wins its slot)."""
    cap, d, o = 5, 2, 1
    rng = np.random.default_rng(1)
    Xb = T(rng.normal(size=(2, 9, d)).astype(f32))
    Yb = T(rng.normal(size=(2, 9, o)).astype(f32))
    valid = T(rng.random((2, 9)) > 0.2)
    start = RingBuffer.create(cap, d, o, "cpu", lanes=2).add(Xb[:, 0] + 5.0, Yb[:, 0])
    got = start.add_batch_masked(Xb, Yb, valid)
    for b in range(2):
        ref = dataclasses.replace(start, X=start.X[b], Y=start.Y[b], head=start.head[b],
                                  count=start.count[b])
        for i in range(9):
            if bool(valid[b, i]):
                ref = ref.add(Xb[b, i], Yb[b, i])
        assert int(got.head[b]) == int(ref.head) and int(got.count[b]) == int(ref.count)
        torch.testing.assert_close(got.X[b], ref.X, rtol=0, atol=0)
        torch.testing.assert_close(got.Y[b], ref.Y, rtol=0, atol=0)


def test_data_buffer_and_updater_cadence_match_jax():
    """OnlineGPUpdater at 4 lanes: the per-lane do_update/do_refit flags of
    every step, the counters, the rejects and the statistics, against the
    JAX updater under vmap (a point admitted into a full buffer does not
    count as accepted, in both)."""
    B, d, o = 4, 3, 2
    cfg_kw = dict(capacity=5, update_interval=3, refit_interval=4, min_distance=0.5)
    rng = np.random.default_rng(2)
    ju = lanes_of(JaxUpdater.create(JaxUpdateConfig(**cfg_kw), d, o), B)
    tu = OnlineGPUpdater.create(OnlineUpdateConfig(**cfg_kw), d, o, device="cpu", lanes=B)
    j_obs = jax.vmap(lambda u, x, y: u.observe(x, y))
    X = rng.normal(size=(14, B, d)).astype(f32)
    X[4:7, 2] = X[3, 2]  # lane 2 repeats a point: rejected
    X[9:, 0] = X[8, 0] + 0.1
    for step in range(14):
        y = rng.normal(size=(B, o)).astype(f32)
        ju, jup, jre = j_obs(ju, X[step], y)
        tu, tup, tre = tu.observe(T(X[step]), T(y))
        np.testing.assert_array_equal(tup.numpy(), np.asarray(jup), err_msg=f"step {step}")
        np.testing.assert_array_equal(tre.numpy(), np.asarray(jre), err_msg=f"step {step}")
        for name in ("n_since_update", "n_since_refit", "n_updates"):
            np.testing.assert_array_equal(getattr(tu, name).numpy(), np.asarray(getattr(ju, name)))
        np.testing.assert_array_equal(tu.buffer.n_rejected.numpy(), np.asarray(ju.buffer.n_rejected))
        assert_buffer(tu.buffer, ju.buffer)
    assert int(tu.buffer.n_rejected.max()) >= 3 and int(tu.n_updates.min()) >= 1
    np.testing.assert_allclose(tu.buffer.min_distance_to(T(X[0])).numpy(),
                               jax.vmap(lambda b, x: b.min_distance_to(x))(ju.buffer, X[0]),
                               atol=1e-6)
    ts, js = tu.buffer.get_statistics(), jax.vmap(lambda b: b.get_statistics())(ju.buffer)
    assert ts["capacity"] == 5
    np.testing.assert_allclose(ts["fill_fraction"].numpy(), js["fill_fraction"], rtol=1e-6)
    # the single buffer: add with and without a gate
    jd = JaxDataBuffer.create(3, d, o).add(X[0, 0], X[0, 0, :o]).add(X[1, 0], X[1, 0, :o],
                                                                     jnp.asarray(False))
    td = DataBuffer.create(3, d, o, "cpu").add(T(X[0, 0]), T(X[0, 0, :o]))
    td = td.add(T(X[1, 0]), T(X[1, 0, :o]), torch.tensor(False))
    assert int(td.n_rejected) == int(jd.n_rejected) == 1
    assert_buffer(td, jd)


def test_residual_collector_residual_matches_jax():
    """residual of a 7- and a 14-state transition batch, and collect_batch."""
    rng = np.random.default_rng(3)
    jp = JaxParams()
    jpt = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    mp = main_path("cpu")
    x = np.tile(np.array([2.0, 20.0, 0, 0, -3.0, 0, 0], f32), (6, 1))
    x += 0.3 * rng.normal(size=x.shape).astype(f32)
    u = (np.array([2.0, 0, 0]) + 0.3 * rng.normal(size=(6, 3))).astype(f32)
    jF = lambda a, b: jr3.step(jp, a, b, DT)
    xn = np.asarray(jax.vmap(lambda a, b: jr3.step(jpt, a, b, DT))(x, u))
    jr = jax.vmap(lambda a, b, c: JaxCollector(dt=DT).residual(jF, a, b, c))(x, u, xn)
    col = ResidualCollector(dt=DT)
    np.testing.assert_allclose(col.residual(mp.F, T(x), T(u), T(xn)).numpy(), jr, atol=1e-4)
    np.testing.assert_allclose(col.collect_batch(mp.F, T(x), T(u), T(xn)).numpy(), jr, atol=1e-4)
    tp = Rocket6DoFParams(device="cpu")
    x14 = tr6.create_initial_state(tp, altitude=10.0).repeat(3, 1)
    xn14 = x14 + 0.01
    r = col.residual(lambda a, b: a, x14, T(u[:3]), xn14)
    assert r.shape == (3, 6)
    torch.testing.assert_close(r, torch.full((3, 6), 0.1), rtol=1e-4, atol=1e-4)


def test_recent_Z_fifo_matches_jax():
    """The newest-first window of each lane's ring, envelope rows beyond its
    count, at lanes with 6, 1 and 0 points and one that has wrapped."""
    cap, d, M = 8, 2, 4
    counts = (6, 1, 0, 11)
    jZ, tZ = [], []
    Z_env = np.full((M, d), -1.0, f32)
    tb = RingBuffer.create(cap, d, 1, "cpu", lanes=len(counts))
    for i in range(max(counts)):
        x = np.stack([np.full(d, float(i) if i < c else 0.0, f32) for c in counts])
        grow = torch.tensor([i < c for c in counts])
        tb, _ = tb.add_if_novel(T(x), torch.zeros(len(counts), 1), -1.0, accept=grow)
    for b, c in enumerate(counts):
        jb = JaxRing.create(cap, d, 1)
        for i in range(c):
            jb = jb.add(jnp.full((d,), float(i)), jnp.zeros(1))
        jZ.append(np.asarray(jax_recent_Z(jb, Z_env)))
    tZ = _recent_Z(tb, T(np.stack([Z_env] * len(counts)))).numpy()
    np.testing.assert_array_equal(tZ, np.stack(jZ))
    np.testing.assert_array_equal(tZ[0, :, 0], [5.0, 4.0, 3.0, 2.0])
    np.testing.assert_array_equal(tZ[1, :, 0], [0.0, -1.0, -1.0, -1.0])
    np.testing.assert_array_equal(tZ[2], Z_env)
    np.testing.assert_array_equal(tZ[3, :, 0], [10.0, 9.0, 8.0, 7.0])


# -- the lane-batched sparse GP ------------------------------------------------------


def _gp_problem(B=3, cap=20, d=4, M=6, o=3, seed=4):
    """B lanes of a well-conditioned three-output problem (noise 0.1), with
    10, 20 and 0 active points."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, cap, d)).astype(f32)
    Y = rng.normal(size=(B, o, cap)).astype(f32)
    Z = rng.normal(size=(B, M, d)).astype(f32)
    mask = np.zeros((B, cap), bool)
    mask[0, :10], mask[1, :] = True, True
    ll = (0.3 * rng.normal(size=(B, o, d)) + 0.3).astype(f32)
    lv = (0.2 * rng.normal(size=(B, o))).astype(f32)
    ln = np.full((B, o), np.log(0.1), f32) + (0.1 * rng.normal(size=(B, o))).astype(f32)
    Xq = rng.normal(size=(B, 7, d)).astype(f32)
    return X, Y, Z, mask, ll, lv, ln, Xq


def test_lane_batched_refit_and_predict_match_a_jax_loop():
    """One batched refit and prediction over 3 lanes (one with no data)
    against a per-lane loop of the JAX refit_sparse_multi and
    predict_sparse_multi, at 1e-5; the single-GP call on each lane's arrays
    gives that lane's result (1e-6), and sparse_lml takes the lane axis."""
    X, Y, Z, mask, ll, lv, ln, Xq = _gp_problem()
    k = SquaredExponentialARD(log_variance=T(lv), log_lengthscales=T(ll))
    st = refit_sparse_multi(k, T(Z), T(X), T(Y), T(mask), T(ln), "fitc")
    pr = predict_sparse_multi(st, T(Xq))
    assert st.Luu_inv.shape == (3, 3, 6, 6) and st.c.shape == (3, 3, 6)
    assert pr.mean.shape == pr.variance.shape == (3, 7, 3)
    lml = sparse_lml(k, T(Z), T(X), T(Y), T(mask), T(ln), "fitc")
    assert lml.shape == (3, 3)
    for b in range(3):
        jk = JaxSE(log_variance=jnp.asarray(lv[b]), log_lengthscales=jnp.asarray(ll[b]))
        js = jax_refit(jk, Z[b], X[b], Y[b], mask[b], ln[b], "fitc")
        jpr = jax_predict(js, Xq[b])
        for name in ("Luu_inv", "LB_inv", "c"):
            np.testing.assert_allclose(getattr(st, name)[b].numpy(), getattr(js, name), atol=1e-5,
                                       err_msg=f"lane {b} {name}")
        np.testing.assert_allclose(pr.mean[b].numpy(), jpr.mean, atol=1e-5)
        np.testing.assert_allclose(pr.variance[b].numpy(), jpr.variance, atol=1e-5)
        kb = SquaredExponentialARD(log_variance=T(lv[b]), log_lengthscales=T(ll[b]))
        sb = refit_sparse_multi(kb, T(Z[b]), T(X[b]), T(Y[b]), T(mask[b]), T(ln[b]), "fitc")
        pb = predict_sparse_multi(sb, T(Xq[b]))
        for name in ("Luu_inv", "LB_inv", "c"):
            torch.testing.assert_close(getattr(sb, name), getattr(st, name)[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(pb.mean, pr.mean[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(pb.variance, pr.variance[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(
            sparse_lml(kb, T(Z[b]), T(X[b]), T(Y[b]), T(mask[b]), T(ln[b]), "fitc"), lml[b],
            rtol=1e-6, atol=1e-4)


def _stored_z_problem(seed, d=11, cap=48, M=32):
    """A store along a smooth trajectory, Z its latest M points (the online
    refit's re-centring), noise 1e-4: B = I + AAᵀ is PD in exact arithmetic
    only."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, cap)[:, None]
    X = (np.sin(t * rng.uniform(1, 3, (1, d)) + rng.uniform(0, 3, (1, d))) * rng.uniform(0.5, 3, (1, d))
         + 0.001 * rng.normal(size=(cap, d))).astype(f32)
    y = rng.normal(size=cap).astype(f32)
    ll = np.full(d, np.log(rng.uniform(0.5, 2.0)), f32)
    return X, X[-M:].copy(), y, ll


@pytest.mark.parametrize("seed", [15, 18, 21])
def test_refit_on_stored_inducing_points_keeps_a_finite_factor(seed):
    """Where Z sits on stored points, the JAX package's one-level f32
    factorization of B fails and hands over a NaN factor; the port's B takes
    the 1e-3 relative jitter instead: LB⁻¹ is finite with entries at most 1
    (B ⪰ I), and the posterior is finite."""
    from gpmpc_tpu.gp.sparse_gp import _factors as jax_factors

    X, Z, y, ll = _stored_z_problem(seed)
    ln = f32(np.log(1e-4))
    jo = jax_factors(JaxSE(log_variance=jnp.asarray(0.0), log_lengthscales=jnp.asarray(ll)),
                     jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y), jnp.ones(48, bool),
                     jnp.asarray(ln), "fitc")
    assert not np.isfinite(np.asarray(jo[1])).all()
    k = SquaredExponentialARD(log_variance=torch.zeros(1), log_lengthscales=T(ll[None]))
    st = refit_sparse_multi(k, T(Z), T(X), T(y[None]), torch.ones(48, dtype=torch.bool),
                            T(np.array([ln])))
    assert bool(torch.isfinite(st.LB_inv).all()) and float(st.LB_inv.abs().max()) <= 1.0 + 1e-5
    pr = predict_sparse_multi(st, T(X[::5] + 0.01))
    assert bool(torch.isfinite(pr.mean).all() & torch.isfinite(pr.variance).all())


def test_lane_gp_predicts_per_lane_and_checks_the_lane_count():
    """A GP per lane answers (B, ...) queries with each lane's GP, gated per
    lane; a query whose dim 0 is not the lane count raises."""
    X, Y, Z, mask, ll, lv, ln, _ = _gp_problem(d=11)
    gp = Simple3DoFGP.create(StructuredGPConfig(max_data_points=20, n_inducing=6), "cpu", lanes=3)
    k = SquaredExponentialARD(log_variance=T(lv), log_lengthscales=T(ll))
    gp = dataclasses.replace(gp, gp=refit_sparse_multi(k, T(Z), T(X), T(Y), T(mask), T(ln)),
                             is_fitted=True)
    assert gp.lanes == 3 and gp.buffer_count.shape == (3,)
    rng = np.random.default_rng(5)
    x = T(np.concatenate([rng.uniform(1.5, 2.5, (3, 5, 1)), rng.normal(size=(3, 5, 6))],
                         axis=-1).astype(f32))
    u = T(rng.normal(size=(3, 5, 3)).astype(f32))
    m, v = gp.predict(x, u)
    g, _ = gp.predict_gated(x, u)
    assert m.shape == v.shape == (3, 5, 3)
    for b in range(3):
        single = dataclasses.replace(gp, gp=refit_sparse_multi(
            SquaredExponentialARD(log_variance=T(lv[b]), log_lengthscales=T(ll[b])),
            T(Z[b]), T(X[b]), T(Y[b]), T(mask[b]), T(ln[b])))
        mb, vb = single.predict(x[b], u[b])
        gb, _ = single.predict_gated(x[b], u[b])
        torch.testing.assert_close(mb, m[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(vb, v[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(gb, g[b], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="3 lanes"):
        gp.predict(x[:2], u[:2])


def descent_states(n, seed):
    """Random 6-DoF descent states near upright and thrusts around hover."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 14), f32)
    x[:, 0] = 1.6 + 0.3 * rng.random(n)
    x[:, 1] = 5.0 + 10.0 * rng.random(n)
    x[:, 4:7] = np.array([-2.0, 0.1, 0.0]) + 0.5 * rng.normal(size=(n, 3))
    q = np.array([1.0, 0, 0, 0]) + 0.1 * rng.normal(size=(n, 4))
    x[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 11:14] = 0.1 * rng.normal(size=(n, 3))
    u = (np.array([2.0, 0, 0]) + 0.3 * rng.normal(size=(n, 3))).astype(f32)
    return x, u


def jax_structured_gp(n=40, M=12, seed=0):
    """A small JAX StructuredRocketGP fitted on random descent transitions."""
    x, u = descent_states(n, seed)
    R = (0.2 * np.random.default_rng(seed + 100).normal(size=(n, 6))).astype(f32)
    gp = JaxSGP.create(JaxGPConfig(max_data_points=n, n_inducing=M))
    return gp.add_data_batch(jnp.asarray(x), jnp.asarray(u), jnp.asarray(R)).fit(
        jax.random.PRNGKey(seed)), x, u


def jax_gp_numpy(gp) -> dict:
    """The dict ``convert`` takes, from a JAX Simple3DoFGP or
    StructuredRocketGP (a GP per lane or one)."""
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


def test_is_novel_save_load_and_add_data_match_jax(tmp_path):
    """StructuredRocketGP.is_novel on held-out and training states against
    JAX; add_data and add_data_batch_masked of both models against JAX; a
    GP (one, or one per lane) saved to .npz and loaded back is the same."""
    jgp, x, u = jax_structured_gp()
    tgp = convert.structured_rocket_gp_from_numpy(jax_gp_numpy(jgp), device="cpu")
    assert tgp.config.novelty_threshold == jgp.config.novelty_threshold == 0.3
    xq, uq = descent_states(16, seed=7)
    xs, us = np.concatenate([xq, x[:8]]), np.concatenate([uq, u[:8]])
    j_nov = np.asarray(jax.vmap(jgp.is_novel)(xs, us))
    t_nov = tgp.is_novel(T(xs), T(us))
    np.testing.assert_array_equal(t_nov.numpy(), j_nov)
    assert j_nov.any() and not j_nov.all()
    # one transition, then a masked batch, into both stores
    r = np.random.default_rng(8).normal(size=(5, 6)).astype(f32)
    valid = np.array([True, False, True, True, False])
    j2 = jgp.add_data(xq[0], uq[0], r[0]).add_data_batch_masked(xq[:5], uq[:5], r, valid)
    t2 = tgp.add_data(T(xq[0]), T(uq[0]), T(r[0])).add_data_batch_masked(
        T(xq[:5]), T(uq[:5]), T(r), T(valid))
    assert_buffer(t2.trans_buffer, j2.trans_buffer, atol=1e-5)
    assert_buffer(t2.rot_buffer, j2.rot_buffer, atol=1e-5)
    x7 = xq[:5, :7]
    jg3 = jax.vmap(lambda a, b, c: JaxSimple3(a, b, c))(x7, uq[:5], r[:, :3])
    tg3 = Simple3DoFGP.create(StructuredGPConfig(max_data_points=4), "cpu", lanes=5)
    tg3 = tg3.add_data(T(x7), T(uq[:5]), T(r[:, :3]))
    assert_buffer(tg3.buffer, jg3.buffer, atol=1e-5)
    # persistence
    path = str(tmp_path / "sgp.npz")
    t2.save(path)
    back = tgp.load(path)
    for a, b in ((back.trans_gp.c, t2.trans_gp.c), (back.rot_buffer.X, t2.rot_buffer.X),
                 (back.trans_buffer.head, t2.trans_buffer.head)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    lane_path = str(tmp_path / "lanes.npz")
    tg3.save(lane_path)
    with np.load(lane_path) as data:
        assert data["buffer.X"].shape == (5, 4, 11) and data["buffer.count"].shape == (5,)
    fresh = Simple3DoFGP.create(StructuredGPConfig(max_data_points=4), "cpu", lanes=5)
    loaded = fresh.load(lane_path)
    torch.testing.assert_close(loaded.buffer.X, tg3.buffer.X, rtol=0, atol=0)
    torch.testing.assert_close(loaded.buffer.count, tg3.buffer.count, rtol=0, atol=0)


def JaxSimple3(x, u, r):
    """One JAX Simple3DoFGP (capacity 4) holding one transition."""
    from gpmpc_tpu.gp import Simple3DoFGP as JaxSimple3DoFGP

    return JaxSimple3DoFGP.create(JaxGPConfig(max_data_points=4)).add_data(x, u, r)


# -- the online controller -------------------------------------------------------------


def jax_gp_cfg(N=N):
    """bench.py:116-125, the plain ADMM iteration."""
    return JaxGPMPCConfig(
        base=JaxRTIConfig(N=N, accept_pri_tol=1e-2, condensed=True, x_bound_mask=(False,) * 7,
                          admm=JaxADMMConfig(max_iter=50, check_interval=50, polish=False,
                                             adaptive_rho=False, scaling=2, use_pallas="off",
                                             infeas_certs=False, iter_unroll=25)),
        scp_iterations=1, tighten=True, rollout_gp_tape=True)


def jax_plant():
    """(nominal step, drag plant) of the JAX package; the plant jitted over
    lanes, as the teacher steps it."""
    jp = JaxParams()
    jpt = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    return (lambda a, b: jr3.step(jp, a, b, DT)), JAX_FLEET_PLANT


JAX_FLEET_PLANT = jax.jit(jax.vmap(lambda a, b: jr3.step(
    JaxParams().replace(rho=1.0, C_D=1.0, A_ref=0.1), a, b, DT)))


XT7 = np.array([2.0, 0, 0, 0, 0, 0, 0], f32)


@pytest.mark.parametrize("model", ["3dof", "6dof"])
def test_init_online_gp_matches_jax(model):
    """The envelope GP of each lane: Z, the lengthscales, the priors and the
    noise at 1e-5; on the empty store LB⁻¹ = I and c = 0 in both packages;
    each of the lanes × outputs Gram matrices takes JAX's jitter level; the
    envelope posterior at descent states is JAX's (mean 0, variance the
    prior) at 1e-5. Luu⁻¹ itself is not compared entry by entry: the f32
    envelope Gram (with its 1e-6 jitter) is indefinite in both packages, so
    both take the 1e-3 level, and the inverse of that nearly singular factor
    turns the reduction-order differences of the two f32 Grams into entry
    differences far above 1e-5."""
    from gpmpc_tpu.ops.linalg import robust_cholesky as jax_robust_cholesky
    from gpmpc_tpu_torch.ops.linalg import robust_cholesky

    rng = np.random.default_rng(9)
    if model == "3dof":
        x0 = np.tile(np.array([2.0, 30.0, 0, 0, -3.0, 0, 0], f32), (3, 1))
        xT, horizon = XT7, 200
    else:
        tp = Rocket6DoFParams(device="cpu")
        x0 = np.tile(tr6.create_initial_state(tp, altitude=20.0, velocity=(-2.0, 0.1, 0.0))
                     .numpy(), (3, 1))
        xT, horizon = tr6.create_initial_state(tp, altitude=0.0).numpy(), 150
    x0[:, 1] += rng.uniform(-3.0, 3.0, 3).astype(f32)
    x0[:, 2:4] += rng.normal(size=(3, 2)).astype(f32)
    jcfg = JaxOnlineConfig(mpc=jax_gp_cfg())
    tcfg = OnlineGPMPCConfig(mpc=main_path("cpu").config)
    jgp = jax.vmap(lambda a: jax_init_online_gp(jcfg, a, jnp.asarray(xT), horizon))(x0)
    tgp = init_online_gp(tcfg, T(x0), T(xT), horizon)
    blocks = ((tgp.trans_gp, jgp.trans_gp), (tgp.rot_gp, jgp.rot_gp)) if model == "6dof" else (
        (tgp.gp, jgp.gp),)
    assert tgp.lanes == 3 and tgp.is_fitted
    for tg, jg in blocks:
        assert tg.Z.shape == (3, 32, jg.Z.shape[-1])
        np.testing.assert_allclose(tg.Z.numpy(), jg.Z, atol=1e-5)
        np.testing.assert_allclose(tg.kernels.log_lengthscales.numpy(), jg.kernels.log_lengthscales,
                                   atol=1e-5)
        np.testing.assert_allclose(tg.kernels.log_variance.numpy(), jg.kernels.log_variance,
                                   atol=1e-5)
        np.testing.assert_allclose(tg.log_noise.numpy(), jg.log_noise, atol=1e-5)
        eye = np.broadcast_to(np.eye(32, dtype=f32), tg.LB_inv.shape)
        np.testing.assert_array_equal(tg.LB_inv.numpy(), eye)
        np.testing.assert_array_equal(np.asarray(jg.LB_inv), eye)
        assert not tg.c.any() and not np.asarray(jg.c).any()
        Kt = tg.kernels(tg.Z, tg.Z) + 1e-6 * torch.eye(32)
        _, used = robust_cholesky(Kt, jitters=(0.0, 1e-3))
        assert bool((used > 0).all())
        assert float(torch.linalg.eigvalsh(Kt.double()).min()) < 0.0
        for b in range(3):
            for o in range(3):
                k = JaxSE(log_variance=jg.kernels.log_variance[b, o],
                          log_lengthscales=jg.kernels.log_lengthscales[b, o])
                Kj = k(jg.Z[b], jg.Z[b]) + 1e-6 * jnp.eye(32)
                _, j_used = jax_robust_cholesky(Kj, jitters=(0.0, 1e-3))
                np.testing.assert_allclose(float(used[b, o]), float(j_used), rtol=1e-3)
    # the envelope posterior along a descent near each lane's
    xq = np.repeat(x0[:, None], 5, 1) + 0.2 * rng.normal(size=(3, 5, x0.shape[1])).astype(f32)
    if model == "6dof":
        xq[..., 7:11] = x0[:, None, 7:11]
    uq = np.tile(np.array([2.0, 0.0, 0.0], f32), (3, 5, 1))
    m_t, v_t = tgp.predict(T(xq), T(uq))
    m_j, v_j = jax.vmap(jax.vmap(lambda g, a, b: g.predict(a, b), (None, 0, 0)))(jgp, xq, uq)
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=1e-5)


@pytest.fixture(scope="module")
def jax_online():
    """The JAX 3-DoF online controller of the bench (ref_horizon 200,
    err_len 8) at both cadences, its vmapped step jitted with k an array."""
    jF, _ = jax_plant()
    out = {}
    for name, kw in (("bench", {}), ("fast", FAST)):
        cinit, cstep = jax_make_online(jF, JaxOnlineConfig(mpc=jax_gp_cfg(), **kw),
                                       jnp.asarray(XT7), lambda x0: jax_cdr(x0, jnp.asarray(XT7),
                                                                            100, DT), 200, 8)
        step = jax.jit(lambda s, x, k, cstep=cstep: jax.vmap(lambda a, b: cstep(a, b, k))(s, x))
        out[name] = (jax.vmap(cinit), step, cinit)
    return out


FAST = dict(refit_every=3, refresh_every=5, min_points=4, min_points_hypers=8)


def port_online(**kw):
    op = online_path("cpu")
    return make_online_gp_mpc_controller(op.F, OnlineGPMPCConfig(mpc=op.config.mpc, **kw),
                                         op.x_target, op.reference_fn, op.ref_horizon, op.err_len)


def fleet(B=4):
    x0 = np.tile(np.array([2.0, 30.0, 0, 0, -3.0, 0, 0], f32), (B, 1))
    x0[:, 1] += np.linspace(0.0, 5.0, B, dtype=f32)
    return x0


def assert_online_states(ts, js, k, tol=1e-4):
    """Counts, heads and counters exactly; the stores, Z and err_hist within
    ``tol``."""
    msg = f"cycle {k}"
    blocks = (((ts.gp.trans_buffer, js.gp.trans_buffer, ts.gp.trans_gp, js.gp.trans_gp),
               (ts.gp.rot_buffer, js.gp.rot_buffer, ts.gp.rot_gp, js.gp.rot_gp))
              if isinstance(ts.gp, StructuredRocketGP)
              else ((ts.gp.buffer, js.gp.buffer, ts.gp.gp, js.gp.gp),))
    for tb, jb, tg, jg in blocks:
        np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count), err_msg=msg)
        np.testing.assert_array_equal(tb.head.numpy(), np.asarray(jb.head), err_msg=msg)
        np.testing.assert_allclose(tb.X.numpy(), jb.X, atol=tol, err_msg=msg)
        np.testing.assert_allclose(tb.Y.numpy(), jb.Y, atol=tol, err_msg=msg)
        np.testing.assert_allclose(tg.Z.numpy(), jg.Z, atol=tol, err_msg=msg)
        np.testing.assert_allclose(tg.kernels.log_lengthscales.numpy(),
                                   jg.kernels.log_lengthscales, atol=tol, err_msg=msg)
        np.testing.assert_allclose(tg.kernels.log_variance.numpy(), jg.kernels.log_variance,
                                   atol=tol, err_msg=msg)
    for name in ("n_accepted", "n_refits", "have_prev"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=f"{msg} {name}")
    np.testing.assert_allclose(ts.err_hist.numpy(), js.err_hist, atol=tol, err_msg=msg)


def teacher_forced(jstep, js, tstep, ts, xs, jF_true, k0, cycles, freeze=None):
    """Fly both controllers on the JAX package's transitions: both are given
    the JAX plant's state, and the port's flown control is set to the JAX
    package's, so both stores take the same rows. u0 within 1e-3 each cycle
    (the ADMM's f32 reordering over 50 iterations), the states as in
    :func:`assert_online_states`. ``freeze`` (lane, first, last) holds a
    lane's state over those cycles, as a stopped lane's."""
    hold = None
    for k in range(k0, k0 + cycles):
        if freeze is not None and freeze[1] <= k <= freeze[2]:
            hold = xs[freeze[0]] if hold is None else hold
            xs = xs.at[freeze[0]].set(hold)
        uj, js = jstep(js, xs, jnp.asarray(k, jnp.int32))
        ut, ts = tstep(ts, T(xs), k)
        np.testing.assert_allclose(ut.numpy(), uj, atol=1e-3, err_msg=f"cycle {k}")
        ts = dataclasses.replace(ts, u_prev=T(uj))
        assert_online_states(ts, js, k)
        xs = jF_true(xs, uj)
    return js, ts, xs


@pytest.mark.parametrize("cadence", ["bench", "fast"])
def test_online_cycle_teacher_forced_matches_jax(jax_online, cadence):
    """25 cycles of the bench's online controller at 4 lanes, from an empty
    GP: through the refit at k = 9 and the refresh at k = 19 ("bench"), or
    with refits every 3 and refreshes every 5 cycles, the gate at 4 points
    and the refresh at 8, while lane 0 is held on one state for cycles 3-10,
    so that the refresh takes some lanes and not others ("fast")."""
    jinit, jstep, _ = jax_online[cadence]
    _, jF_true = jax_plant()
    x0 = fleet()
    tinit, tstep = port_online(**(FAST if cadence == "fast" else {}))
    js, ts = jinit(jnp.asarray(x0)), tinit(T(x0))
    before = K.LAUNCHES
    js, ts, _ = teacher_forced(jstep, js, tstep, ts, jnp.asarray(x0), jF_true, 0, 25,
                               freeze=(0, 3, 10) if cadence == "fast" else None)
    assert K.LAUNCHES == before  # CPU tensors run the plain version
    # bench: the refit at 9, the refresh at 19; fast: refits at 2, 5, 8, 11,
    # 17, 20, 23 and refreshes at 4, 9, 14, 19, 24
    assert int(ts.n_refits[0]) == (2 if cadence == "bench" else 12)
    if cadence == "fast":
        counts = ts.gp.buffer_count
        assert int(counts[0]) < int(counts[1])
        lv = ts.gp.gp.kernels.log_variance
        assert not torch.allclose(lv[0], lv[1])  # lane 0 kept its prior longer


def online_state_from_jax(js) -> OnlineGPMPCState:
    """The port's controller state from a (vmapped) JAX OnlineGPMPCState: the
    GP through ``convert.online_gp_from_numpy``, the rest field by field."""
    f = lambda a: T(np.asarray(a))
    return OnlineGPMPCState(
        mpc=GPMPCState(X_lin=f(js.mpc.X_lin), U_lin=f(js.mpc.U_lin), x_ref=f(js.mpc.x_ref),
                       rho=f(js.mpc.rho), y_prev=f(js.mpc.y_prev)),
        Xr=f(js.Xr), gp=convert.online_gp_from_numpy(jax_gp_numpy(js.gp), device="cpu"),
        x_prev=f(js.x_prev), u_prev=f(js.u_prev), have_prev=f(js.have_prev),
        n_accepted=f(js.n_accepted).to(torch.int32), n_refits=f(js.n_refits).to(torch.int32),
        err_hist=f(js.err_hist))


def test_jax_state_carried_across_continues_like_jax(jax_online):
    """A JAX flight of 10 cycles carried across by convert at cycle 10 (its
    GP refit at k = 9), then 5 more cycles in both packages, teacher forced,
    with the GP switching on at 12 points. The bench's cadence: with the
    fast one, the refit at k = 11 on 10 points is so ill-conditioned in f32
    that the two packages' posteriors move lane 0's u0 apart by about the
    tolerance."""
    jinit, jstep, _ = jax_online["bench"]
    _, jF_true = jax_plant()
    xs = jnp.asarray(fleet())
    js = jinit(xs)
    for k in range(10):
        uj, js = jstep(js, xs, jnp.asarray(k, jnp.int32))
        xs = jF_true(xs, uj)
    ts = online_state_from_jax(js)
    assert ts.gp.lanes == 4 and int(ts.gp.buffer_count[0]) == 9
    assert_online_states(ts, js, 10, tol=0.0)
    _, tstep = port_online()
    _, ts, _ = teacher_forced(jstep, js, tstep, ts, xs, jF_true, 10, 5)
    assert int(ts.gp.buffer_count[0]) == 14 and int(ts.n_refits[0]) == 1


def test_carry_gp_between_episodes_and_replay(jax_online):
    """carry_gp_between_episodes keeps the GPs and counters and starts the
    rest anew, as in JAX; online_controller_info exports the trace; a step
    leaves its input state untouched, so a snapshot replays exactly."""
    jinit, jstep, jcinit = jax_online["fast"]
    _, jF_true = jax_plant()
    tinit, tstep = port_online(**FAST)
    x0 = fleet(2)
    ts = tinit(T(x0))
    xs = T(x0)
    for k in range(7):
        u, ts = tstep(ts, xs, k)
        xs = T(np.asarray(jF_true(jnp.asarray(xs.numpy()), jnp.asarray(u.numpy()))))
    snap = {n: t.clone() for n, t in (("X", ts.gp.buffer.X), ("c", ts.gp.gp.c),
                                      ("X_lin", ts.mpc.X_lin), ("err", ts.err_hist))}
    u1, s1 = tstep(ts, xs, 8)
    u2, s2 = tstep(ts, xs, 8)  # a refit cycle, replayed from the same state
    torch.testing.assert_close(u1, u2, rtol=0, atol=0)
    torch.testing.assert_close(s1.gp.gp.c, s2.gp.gp.c, rtol=0, atol=0)
    for n, t in (("X", ts.gp.buffer.X), ("c", ts.gp.gp.c), ("X_lin", ts.mpc.X_lin),
                 ("err", ts.err_hist)):
        torch.testing.assert_close(t, snap[n], rtol=0, atol=0, equal_nan=True)
    info = online_controller_info(s1)
    assert set(info) == {"err_hist", "gp_points", "n_accepted", "n_refits"}
    assert info["gp_points"].shape == (2,) and int(info["n_refits"][0]) == 4
    x_next = x0 + np.array([0, -10.0, 0.5, 0, 0, 0, 0], f32)
    tc = carry_gp_between_episodes(tinit, s1, T(x_next))
    assert tc.gp is s1.gp and torch.equal(tc.n_refits, s1.n_refits)
    assert torch.equal(tc.n_accepted, s1.n_accepted)
    assert not bool(tc.have_prev.any()) and bool(torch.isnan(tc.err_hist).all())
    js = jinit(jnp.asarray(x0))
    jc = jax.vmap(lambda s, a: jax_carry(jcinit, s, a))(js, jnp.asarray(x_next))
    np.testing.assert_allclose(tc.Xr.numpy(), jc.Xr, atol=1e-5)
    np.testing.assert_allclose(tc.mpc.X_lin.numpy(), jc.mpc.X_lin, atol=1e-5)
    np.testing.assert_array_equal(tc.x_prev.numpy(), np.asarray(jc.x_prev))


# -- the paths ---------------------------------------------------------------------------


def test_online_paths_are_the_bench_and_campaign_configs():
    """Path E holds the bench's online configuration (bench.py:277-295) and
    the flights the campaign script's (run_campaign_tpu.py --controller
    online_gp_mpc --elide): rows, iterations, cadences and scenario."""
    op = online_path("cpu")
    jcfg = jax_gp_cfg()
    assert op.ref_horizon == 200 and op.err_len == 8
    assert _condensed_admm_cfg(op.config.mpc.base).row_structure == jax_condensed_admm_cfg(
        jcfg.base).row_structure == (("diag", 60),)
    jo = JaxOnlineConfig(mpc=jcfg)
    for name in ("refit_every", "refresh_every", "min_points_hypers", "min_points",
                 "min_distance", "dt"):
        assert getattr(op.config, name) == getattr(jo, name), name
    for name in ("max_data_points", "n_inducing", "noise", "kernel", "method", "novelty_threshold"):
        assert getattr(op.config.gp, name) == getattr(jo.gp, name), name
    for name in ("max_iter", "check_interval", "scaling", "polish", "adaptive_rho",
                 "infeas_certs"):
        assert getattr(op.config.mpc.base.admm, name) == getattr(jcfg.base.admm, name), name
    np.testing.assert_allclose(op.reference_fn(T(fleet(2))).numpy(),
                               jax.vmap(lambda a: jax_cdr(a, jnp.asarray(XT7), 100, DT))(fleet(2)),
                               atol=1e-5)
    f3, f6 = online_flight_path("3dof", "cpu"), online_flight_path("6dof", "cpu")
    assert (f3.ref_horizon, f3.err_len, f3.sim.max_steps, f3.sim.altitude_mean) == (130, 130, 130,
                                                                                    30.0)
    assert (f6.ref_horizon, f6.err_len, f6.sim.max_steps, f6.sim.altitude_mean) == (150, 150, 150,
                                                                                    20.0)
    a6 = f6.config.mpc.base.admm
    assert (a6.max_iter, a6.check_interval, a6.scaling) == (100, 50, 2)
    assert _condensed_admm_cfg(f6.config.mpc.base).row_structure == (("blt", 5, 28, 12),
                                                                     ("diag", 60))
    # the 3-DoF flight's plant adds dt·wind (0.4, 0.25) to the drag plant
    x, u = T(fleet(1)), torch.tensor([[2.0, 0.0, 0.0]])
    d = f3.F_true(x, u) - op.F_true(x, u)
    torch.testing.assert_close(d, torch.tensor([[0, 0, 0, 0, 0, 0.04, 0.025]]), rtol=0, atol=1e-6)


def test_learning_trace_and_a_short_online_campaign():
    """learning_trace computes the campaign script's numbers; fly_online at 3
    lanes over 6 steps, one lane landing at its first step (then frozen by
    the campaign loop through every tensor of the controller state)."""
    rng = np.random.default_rng(11)
    eh = rng.random((5, 40))
    eh[:, :1] = np.nan
    eh[2, 30:] = np.nan
    tr = learning_trace(torch.tensor(eh), 40)
    early, late = np.nanmean(eh[:, 2:12]), np.nanmean(eh[:, 20:])
    assert tr["model_err_cycles_2_12"] == pytest.approx(early)
    assert tr["model_err_cycles_20_plus"] == pytest.approx(late)
    assert tr["model_err_reduction_x"] == pytest.approx(early / late)
    assert tr["err_curve_by5"][0] is None and len(tr["err_curve_by5"]) == 8
    op = online_flight_path("3dof", "cpu")
    op = op._replace(sim=SimulationConfig(max_steps=6), ref_horizon=6, err_len=6)
    x0 = T(fleet(3))
    x0[1, 1], x0[1, 4] = 0.15, -1.0  # touches down in its first step
    res, stats, trace = fly_online(op, x0)
    assert res["steps"].tolist() == [6, 1, 6] and int(res["outcome"][1]) == 0
    assert res["err_hist"].shape == (3, 6) and res["n_refits"].tolist() == [0, 0, 0]
    assert int(res["gp_points"][1]) == 0 and int(res["gp_points"][0]) == 5
    assert float(stats["success_rate"]) == pytest.approx(1.0 / 3.0)
    assert trace["gp_points_mean"] == pytest.approx(10.0 / 3.0) and trace["n_refits_mean"] == 0.0
    assert np.isnan(res["err_hist"][1, 1:].numpy()).all()
