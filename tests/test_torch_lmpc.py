"""The port's LMPC (``gpmpc_tpu_torch/lmpc``) against the JAX package on the
CPU, on ``tests/test_lmpc.py::seeded``'s safe set (one descent-law landing)
and state: one solve of every arm (IPM and ADMM, condensed and sparse,
vertex memory, a candidate pool, the same-trajectory hull), the 14-state
configuration, the stage cost, 20 teacher-forced solves of one episode, a
closed-loop episode, a 4-lane fleet insert and the plan value. Tolerances
are ``tests/test_lmpc.py:123-128``'s: u0 5e-3, λ 5e-2, terminal Q rtol
1e-3."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import lmpc as JL
from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxP3, rocket3dof as jr3
from gpmpc_tpu.terminal import SafeSet as JaxSafeSet
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch import lmpc as TL
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr3
from gpmpc_tpu_torch.main_path import lmpc_fleet_path

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
T = lambda a: torch.tensor(np.asarray(a))
_JP, _TP = JaxP3(), Rocket3DoFParams(device="cpu")
jF = lambda x, u: jr3.step(_JP, x, u, DT)
tF = lambda x, u: tr3.step(_TP, x, u, DT)
XT = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def seeded():
    """tests/test_lmpc.py::seeded: the PD descent law from (2, 20, 0.5, 0,
    −2, 0, 0) until touchdown, in a store of 1024 rows; the same rows in
    the port's store."""
    cfg = JL.LMPCConfig()
    xT = jnp.asarray(XT)
    x = jnp.array([2.0, 20.0, 0.5, 0.0, -2.0, 0.0, 0.0])
    xs, us, cs = [], [], []
    for _ in range(200):
        v_ref = -0.7 * jnp.sqrt(jnp.maximum(x[1], 0.0))
        u = jr3.hover_thrust(_JP, x) + jnp.array(
            [2.0 * (v_ref - x[4]), -1.0 * x[5] - 0.4 * x[2], -1.0 * x[6] - 0.4 * x[3]])
        u = jr3.clamp_thrust(_JP.replace(T_min=0.3, T_max=5.0), u)
        xs.append(x)
        us.append(u)
        cs.append(JL.default_stage_cost(x, u, xT, cfg))
        x = jF(x, u)
        if float(x[1]) < 0.05:
            break
    X, U, C = jnp.stack(xs), jnp.stack(us), jnp.stack(cs)
    jss = JaxSafeSet.create(1024, 7).add_trajectory(X, U, C)
    tss = convert.safe_set_from_numpy(jax.tree.flatten(jss)[0], "cpu")
    return jss, tss, (np.asarray(X), np.asarray(U), np.asarray(C))


def _port_config(jcfg):
    """The port's config from the JAX one's fields."""
    d = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in d.items()}
    d["admm"] = {f: getattr(jcfg.admm, f) for f in jcfg.admm.__dataclass_fields__}
    return convert.lmpc_config_from_fields(d, device="cpu")


def _port_state(js):
    return TL.LMPCState(**{f: T(np.asarray(getattr(js, f)))[None]
                           for f in ("X_lin", "U_lin", "x_ref", "rho", "prev_vertices")})


def _anchored(jcfg, X, U):
    """tests/test_lmpc.py's warm start anchored on the seed flight."""
    return JL.lmpc_init(jcfg, jnp.asarray(X[0]), jnp.asarray(XT)).replace(
        X_lin=jnp.asarray(X[: jcfg.N + 1]), U_lin=jnp.asarray(U[: jcfg.N]))


ARMS = {
    "ipm": {},
    "admm": {"solver": "admm"},
    "admm_sparse": {"solver": "admm", "condensed": False},
    "ipm_sparse_falls_back_to_admm": {"condensed": False},
    "vertex_memory_pool": {"vertex_memory": True, "candidate_pool": 20},
    "pool_dist_weight": {"candidate_pool": 20, "candidate_dist_weight": 1e3},
    "same_trajectory": {"hull_same_trajectory": True},
    "elided_admm": {"solver": "admm", "x_bound_mask": (False,) * 7},
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_single_solve_matches_jax(seeded, arm):
    """One anchored solve at the seed's first state: u0 within 5e-3, λ
    within 5e-2, terminal Q within rtol 1e-3, the same acceptance; the
    carried terminal vertices (vertex memory) compared as sets of states."""
    jss, tss, (X, U, C) = seeded
    jcfg = JL.LMPCConfig(**ARMS[arm])
    cfg = _port_config(jcfg)
    assert cfg.solver == jcfg.solver and cfg.x_bound_mask == jcfg.x_bound_mask
    js = _anchored(jcfg, X, U)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsol, jst = jax.jit(lambda s, x: JL.lmpc_solve(jF, jcfg, jss, s, x))(js, jnp.asarray(X[0]))
        tsol, tst = TL.lmpc_solve(tF, cfg, tss, _port_state(js), T(X[:1]))
    assert bool(tsol.success[0]) == bool(jsol.success) is True
    np.testing.assert_allclose(tsol.u0[0].numpy(), jsol.u0, atol=5e-3)
    np.testing.assert_allclose(tsol.lam[0].numpy(), jsol.lam, atol=5e-2)
    np.testing.assert_allclose(float(tsol.terminal_q[0]), float(jsol.terminal_q), rtol=1e-3)
    np.testing.assert_allclose(tsol.X_opt[0].numpy(), jsol.X_opt, atol=5e-2)
    if jcfg.vertex_memory:
        tv, jv = tst.prev_vertices[0].numpy(), np.asarray(jst.prev_vertices)
        assert (tv >= 0).sum() == (jv >= 0).sum() > 0
        ts_rows = {tuple(r) for r in tss.states.numpy()[tv[tv >= 0]]}
        js_rows = {tuple(r) for r in np.asarray(jss.states)[jv[jv >= 0]]}
        assert ts_rows == js_rows
    else:
        assert torch.equal(tst.prev_vertices, _port_state(js).prev_vertices)
    if jcfg.solver == "ipm":
        assert torch.equal(tst.rho, _port_state(js).rho)


def test_vertex_memory_holds_a_low_q_vertex_against_a_flood(seeded):
    """tests/test_lmpc.py::test_vertex_memory_carries_and_retains in both
    packages: after 40 high-Q near-duplicates of a held vertex join the set,
    the next solve still keeps some held vertex, and the two packages keep
    the same states."""
    jss, tss, (X, U, C) = seeded
    jcfg = JL.LMPCConfig(vertex_memory=True, candidate_pool=20, candidate_dist_weight=0.0)
    cfg = _port_config(jcfg)
    js = _anchored(jcfg, X, U)
    jsolve = jax.jit(lambda ss, s, x: JL.lmpc_solve(jF, jcfg, ss, s, x))
    _, js2 = jsolve(jss, js, jnp.asarray(X[0]))
    _, ts2 = TL.lmpc_solve(tF, cfg, tss, _port_state(js), T(X[:1]))
    held = np.asarray(js2.prev_vertices)
    xq = np.asarray(jss.states)[held[held >= 0][0]]
    Xd = (np.tile(xq[None], (40, 1))
          + 1e-3 * np.random.default_rng(0).normal(size=(40, 7))).astype(np.float32)
    jss_n = jss.add_trajectory(jnp.asarray(Xd), jnp.zeros((40, 3)), jnp.full(40, 1e5))
    tss_n = tss.add_trajectory(T(Xd), torch.zeros(40, 3), torch.full((40,), 1e5))
    _, js3 = jsolve(jss_n, js2, jnp.asarray(X[0]))
    _, ts3 = TL.lmpc_solve(tF, cfg, tss_n, ts2, T(X[:1]))
    kept_t, kept_j = ts3.prev_vertices[0].numpy(), np.asarray(js3.prev_vertices)
    assert np.intersect1d(held[held >= 0], kept_t[kept_t >= 0]).size > 0
    rows = lambda ss, v: {tuple(r) for r in np.asarray(ss.states)[v[v >= 0]]}
    assert rows(tss_n, kept_t) == rows(jss_n, kept_j)


def test_6dof_single_solve_matches_jax():
    """The 14-state configuration (``lmpc_config_6dof``) on a store seeded
    by an upright vertical descent of the quaternion model: one anchored
    solve, the same tolerances; the planned terminal attitude a near-unit
    quaternion."""
    from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxP6, rocket6dof as jr6
    from gpmpc_tpu_torch.dynamics import Rocket6DoFParams, rocket6dof as tr6

    jp = JaxP6()
    jcfg = JL.lmpc_config_6dof(jp)
    cfg = TL.lmpc_config_6dof(Rocket6DoFParams(device="cpu"), device="cpu")
    for name in ("Q", "R", "x_min", "x_max", "u_min", "u_max"):
        np.testing.assert_allclose(getattr(cfg, name).numpy(), np.asarray(getattr(jcfg, name)),
                                   rtol=1e-6)
    assert cfg.n_x == 14 and cfg.m_dry == jcfg.m_dry
    jstep = lambda x, u: jr6.step(jp, x, u, DT)
    tp = Rocket6DoFParams(device="cpu")
    tstep = lambda x, u: tr6.step(tp, x, u, DT)
    xT = jr6.create_initial_state(jp, altitude=0.0)
    x = jr6.create_initial_state(jp, altitude=8.0, velocity=(-1.0, 0.0, 0.0))
    xs, us = [], []
    for _ in range(120):
        u = jnp.array([x[0] * (1.0 + 1.2 * (-0.6 * jnp.sqrt(jnp.maximum(x[1], 0.0)) - x[4])),
                       0.0, 0.0])
        xs.append(x)
        us.append(u)
        x = jstep(x, u)
        if float(x[1]) < 0.05:
            break
    X, U = jnp.stack(xs), jnp.stack(us)
    C = jax.vmap(lambda a, b: JL.default_stage_cost(a, b, xT, jcfg))(X, U)
    jss = JaxSafeSet.create(256, 14).add_trajectory(X, U, C)
    tss = convert.safe_set_from_numpy(jax.tree.flatten(jss)[0], "cpu")
    js = JL.lmpc_init(jcfg, X[0], xT).replace(X_lin=X[: jcfg.N + 1], U_lin=U[: jcfg.N])
    jsol, _ = jax.jit(lambda s, x: JL.lmpc_solve(jstep, jcfg, jss, s, x))(js, X[0])
    tsol, _ = TL.lmpc_solve(tstep, cfg, tss, _port_state(js), T(X[:1]))
    assert bool(tsol.success[0]) == bool(jsol.success) is True
    np.testing.assert_allclose(tsol.u0[0].numpy(), jsol.u0, atol=5e-3)
    np.testing.assert_allclose(tsol.lam[0].numpy(), jsol.lam, atol=5e-2)
    np.testing.assert_allclose(float(tsol.terminal_q[0]), float(jsol.terminal_q), rtol=1e-3)
    qn = float(tsol.X_opt[0, -1, 7:11].norm())
    assert 0.9 < qn < 1.1


def test_default_stage_cost_matches_jax():
    """tests/test_lmpc.py:254: rtol 1e-6, with the touchdown shaping on and
    off, near the ground and at altitude, any leading axes."""
    rng = np.random.default_rng(0)
    xs = np.tile(np.array([2.0, 0.5, 0.0, 0.0, -4.0, 0.0, 0.0], np.float32), (6, 1))
    xs[:, 1] = [0.2, 0.5, 1.5, 3.0, 20.0, 1.0]
    xs[:, 4:7] += rng.normal(size=(6, 3)).astype(np.float32)
    us = (rng.normal(size=(6, 3)) + [2.0, 0, 0]).astype(np.float32)
    for w in (0.0, 250.0):
        jcfg = JL.LMPCConfig(touchdown_speed_weight=w)
        want = jax.vmap(lambda x, u: JL.default_stage_cost(x, u, jnp.asarray(XT), jcfg))(
            jnp.asarray(xs), jnp.asarray(us))
        got = TL.default_stage_cost(T(xs), T(us), T(XT), _port_config(jcfg))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        got2 = TL.default_stage_cost(T(xs).reshape(2, 3, 7), T(us).reshape(2, 3, 3), T(XT),
                                     _port_config(jcfg))
        np.testing.assert_allclose(got2.reshape(-1).numpy(), want, rtol=1e-6)


def test_teacher_forced_episode_matches_jax(seeded):
    """20 steps of one closed-loop episode from the seed's first state: at
    every step the port solves from JAX's warm-start state and JAX's state,
    and u0 agrees within 5e-3."""
    jss, tss, (X, U, C) = seeded
    jcfg = JL.LMPCConfig()
    cfg = _port_config(jcfg)
    js = JL.lmpc_init(jcfg, jnp.asarray(X[0]), jnp.asarray(XT))
    jsolve = jax.jit(lambda s, x: JL.lmpc_solve(jF, jcfg, jss, s, x))
    x = jnp.asarray(X[0])
    for k in range(20):
        tsol, _ = TL.lmpc_solve(tF, cfg, tss, _port_state(js), T(x)[None])
        jsol, js = jsolve(js, x)
        np.testing.assert_allclose(tsol.u0[0].numpy(), jsol.u0, atol=5e-3, err_msg=f"step {k}")
        assert bool(tsol.success[0]) == bool(jsol.success)
        x = jF(x, jsol.u0)


def test_closed_loop_episode_matches_jax(seeded):
    """One closed-loop episode of 180 steps from the seed's first state in
    each package: the same landing and success, steps within ±2, total cost
    within 2%. The port's loop stops once the lane has landed and pads the
    rest as the scan fills it (the frozen state, zero control, zero cost):
    the rows it runs match a longer run of itself bit for bit, and the
    stored episode takes the same slots in both packages."""
    jss, tss, (X, U, C) = seeded
    jcfg = JL.LMPCConfig()
    cfg = _port_config(jcfg)
    jout, jss2 = jax.jit(lambda s, x: JL.run_episode(jF, jcfg, s, x, jnp.asarray(XT), 180))(
        jss, jnp.asarray(X[0]))
    tout, tss2 = TL.run_episode(tF, cfg, tss, T(X[:1]), T(XT), 180)
    assert bool(tout["landed"][0]) == bool(jout["landed"]) is True
    assert bool(tout["success"][0]) == bool(jout["success"])
    assert abs(int(tout["steps"][0]) - int(jout["steps"])) <= 2
    np.testing.assert_allclose(float(tout["total_cost"][0]), float(jout["total_cost"]), rtol=2e-2)
    n = int(tout["steps"][0])
    assert tout["cycles"] == n < 180
    Xp = tout["X"][0, n:]
    assert torch.equal(Xp, tout["x_final"][0].expand_as(Xp))
    assert not bool(tout["U"][0, n:].any()) and not bool(tout["costs"][0, n:].any())
    longer = TL.fly_episode(tF, cfg, tss, T(X[:1]), T(XT), 240)
    assert torch.equal(longer["X"][0, :181], tout["X"][0])
    assert torch.equal(longer["costs"][0, :180], tout["costs"][0])
    for f in ("head", "count", "n_trajectories", "written"):
        assert int(getattr(tss2, f)) == int(getattr(jss2, f)), f
    np.testing.assert_array_equal(tss2.traj_ids.numpy(), np.asarray(jss2.traj_ids))
    np.testing.assert_array_equal(tss2.iterations.numpy(), np.asarray(jss2.iterations))


def test_fleet_round_insert_matches_jax_scan(seeded):
    """``scripts/run_fleet_lmpc_tpu.py:272-279``'s ``add_many`` (a scan of
    single inserts in lane order, failed lanes masked) against the port's
    lane-ordered insert, fed the same 4 trajectories of 150 steps: slot for
    slot, the ring wrap included (capacity 512 < 55 + 4 × 150)."""
    jss0, _, (X, U, C) = seeded
    rng = np.random.default_rng(1)
    Xs = (X[None, :50].repeat(4, 0) + 0.01 * rng.normal(size=(4, 50, 7))).astype(np.float32)
    Xs = np.concatenate([Xs, np.repeat(Xs[:, -1:], 101, axis=1)], axis=1)  # 151 rows
    Us = np.concatenate([U[None, :50].repeat(4, 0), np.zeros((4, 100, 3))], 1).astype(np.float32)
    Cs = np.concatenate([C[None, :50].repeat(4, 0) * (1 + 0.01 * rng.random((4, 1))),
                         np.zeros((4, 100))], 1).astype(np.float32)
    ok = np.array([True, False, True, True])
    for cap in (1024, 512):
        jss = JaxSafeSet.create(cap, 7).add_trajectory(jnp.asarray(X), jnp.asarray(U),
                                                       jnp.asarray(C))
        tss = convert.safe_set_from_numpy(jax.tree.flatten(jss)[0], "cpu")

        @jax.jit
        def add_many(ss, X, U, costs, success):
            def body(ss, tr):
                Xi, Ui, ci, oki = tr
                return ss.add_trajectory(Xi[:-1], Ui, ci, valid=oki), None

            return jax.lax.scan(body, ss, (X, U, costs, success))[0]

        jout = add_many(jss, jnp.asarray(Xs), jnp.asarray(Us), jnp.asarray(Cs), jnp.asarray(ok))
        tout = tss.add_trajectories(T(Xs)[:, :-1], T(Us), T(Cs), valid=torch.tensor(ok))
        for f in ("head", "count", "n_trajectories", "written"):
            assert int(getattr(tout, f)) == int(getattr(jout, f)), (cap, f)
        for f in ("traj_ids", "iterations"):
            np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)))
        for f in ("states", "controls", "fuel_required", "q_values"):
            np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                       rtol=1e-6, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-6)


def test_plan_value_matches_jax(seeded):
    """``lmpc_plan_value`` at the seed's first state, settle 4: the value
    within rtol 1e-3, the same acceptance."""
    jss, tss, (X, U, C) = seeded
    jcfg = JL.LMPCConfig()
    cfg = _port_config(jcfg)
    jv, jok, _ = jax.jit(lambda ss: JL.lmpc_plan_value(jF, jcfg, ss, jnp.asarray(X[0]),
                                                       jnp.asarray(XT), settle=4))(jss)
    tv, tok, tverts = TL.lmpc_plan_value(tF, cfg, tss, T(X[:1]), T(XT), settle=4)
    np.testing.assert_allclose(float(tv[0]), float(jv), rtol=1e-3)
    assert bool(tok[0]) == bool(jok)
    assert tverts.shape == (1, cfg.n_terminal_vertices)


def test_fleet_path_seed_matches_the_script():
    """``main_path.lmpc_fleet_path``'s 3-DoF seed is the campaign script's
    (``scripts/run_fleet_lmpc_tpu.py:40-69``: 200 rows, frozen after
    touchdown) and its cost the artifact's seed cost."""
    lp = lmpc_fleet_path("3dof", "cpu")
    X, U, C = lp.seed
    assert X.shape == (200, 7) and U.shape == (200, 3)
    assert float(C.sum()) == pytest.approx(109252.0, rel=1e-5)  # the artifact's seed_cost
    assert not bool(C[-50:].any())
    assert lp.x0_seed.tolist() == [2.0, 20.0, 0.5, 0.0, -2.0, 0.0, 0.0]


def test_run_fleet_iterations_and_simple_lmpc(seeded):
    """Two lanes, one round: the set grows by the lanes that succeed, in
    lane order; ``SimpleLMPC`` returns a stored control per lane."""
    _, tss, (X, U, C) = seeded
    cfg = TL.LMPCConfig(device="cpu")
    x0s = T(np.stack([X[0], X[0] + np.array([0, 1.0, 0, 0, 0, 0, 0], np.float32)]))
    summ, ss2 = TL.run_fleet_iterations(tF, cfg, tss, x0s, T(XT), n_rounds=1, max_steps=120)
    assert summ[0]["success_rate"] == 1.0
    assert int(ss2.n_trajectories) == int(tss.n_trajectories) + 2
    u = TL.SimpleLMPC(cfg).control(tss, x0s)
    assert u.shape == (2, 3) and bool(torch.isfinite(u).all())
