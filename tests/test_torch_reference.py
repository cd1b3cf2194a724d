"""The port's reference layer against the JAX package's: SCVX (fixed and
free final time, with and without glideslope facet rows), the PD fallback
generator, ``Trajectory`` and ``TrajectoryLibrary`` with every method, bulk
seeding, and ``.npz`` files written by each package and read by the other.

SCVX runs at a small size (N = 10, 4 SCP iterations, 200 ADMM iterations a
subproblem, 3 durations). Its X, U and fuel are held by the witness rule:
within 1e-3 of the JAX package, or twice what the port itself moves under a
1e-7 relative change of the initial state, read in the same test; the
converged flags are equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import reference as JR
from gpmpc_tpu.dynamics import rocket3dof as jr3
from gpmpc_tpu.ops.qp import ADMMConfig as JADMM
from gpmpc_tpu_torch import reference as TR
from gpmpc_tpu_torch.dynamics import rocket3dof as tr3
from gpmpc_tpu_torch.ops.qp import ADMMConfig as TADMM

torch.set_num_threads(1)  # the suite's xdist workers share the cores

X0S = np.array([[2.0, 25.0, 1.0, -0.5, -3.0, 0.0, 0.0],
                [1.95, 22.0, -1.5, 0.8, -2.5, 0.2, -0.1]], np.float32)
XT = np.zeros(7, np.float32)
XT[0] = 2.0
DTS = np.array([0.5, 0.7, 0.9], np.float32)  # t_f 5, 7, 9 s at N = 10
TOL, WITNESS_X = 1e-3, 2.0

JP, TP = jr3.Rocket3DoFParams(), tr3.Rocket3DoFParams(device="cpu")
J_STEP = lambda x, u, dt: jr3.step(JP, x, u, dt)
T_STEP = lambda x, u, dt: tr3.step(TP, x, u, dt)


def _configs(facets):
    kw_j, kw_t = {}, {}
    if facets:
        from gpmpc_tpu.mpc import glideslope_rows as jrows
        from gpmpc_tpu_torch.mpc.rti6dof import glideslope_rows as trows

        names = ("Gx", "gx_l", "gx_u")
        kw_j = dict(zip(names, jrows(math.radians(30.0), 7, 8)))
        kw_t = dict(zip(names, trows(math.radians(30.0), 7, 8)))
    jc = JR.SCVXConfig(N=10, iterations=4, admm=JADMM(max_iter=200, polish=True), **kw_j)
    tc = TR.SCVXConfig(N=10, iterations=4, admm=TADMM(max_iter=200, polish=True), device="cpu",
                       **kw_t)
    return jc, tc


def _witness(fn, x0):
    """The port's own spread under a 1e-7 relative change of x0."""
    gen = torch.Generator().manual_seed(0)
    a = fn(torch.tensor(x0))
    b = fn(torch.tensor(x0) * (1 + 1e-7 * torch.randn(x0.shape, generator=gen)))
    return {k: (getattr(a, k) - getattr(b, k)).abs().max().item() for k in ("X", "U", "fuel_used")}


def _held(out, ref, spread):
    for k in ("X", "U", "fuel_used"):
        d = np.abs(getattr(out, k).numpy() - np.asarray(getattr(ref, k))).max()
        assert d <= max(TOL, WITNESS_X * spread[k]), (k, d, spread[k])
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))


@pytest.mark.parametrize("facets", [False, True], ids=["box", "glideslope"])
def test_scvx_solve_matches_jax(facets):
    jc, tc = _configs(facets)
    x0 = np.repeat(X0S[:1], 3, axis=0)
    ref = jax.jit(jax.vmap(lambda x, dt: JR.scvx_solve(J_STEP, jc, x, jnp.asarray(XT), dt)))(
        jnp.asarray(x0), jnp.asarray(DTS))
    fn = lambda x: TR.scvx_solve(T_STEP, tc, x, torch.tensor(XT), torch.tensor(DTS))
    out = fn(torch.tensor(x0))
    _held(out, ref, _witness(fn, x0))
    np.testing.assert_allclose(out.dt.numpy(), DTS)
    assert out.converged[1:].all()  # 7 s and 9 s land; 5 s does not at N = 10


def test_scvx_free_time_matches_jax():
    jc, tc = _configs(False)
    ref = jax.jit(jax.vmap(lambda x: JR.scvx_free_time(J_STEP, jc, x, jnp.asarray(XT),
                                                       jnp.asarray(DTS))))(jnp.asarray(X0S))
    fn = lambda x: TR.scvx_free_time(T_STEP, tc, x, torch.tensor(XT), torch.tensor(DTS))
    out = fn(torch.tensor(X0S))
    _held(out, ref, _witness(fn, X0S))
    np.testing.assert_array_equal(out.dt.numpy(), np.asarray(ref.dt))
    one = TR.scvx_free_time(T_STEP, tc, torch.tensor(X0S[0]), torch.tensor(XT),
                            torch.tensor(DTS))
    assert one.X.shape == (11, 7) and float(one.dt) == float(out.dt[0])


def test_scvx_free_time_falls_back_to_the_lowest_defect():
    """Where no duration converges, the lowest-defect one is kept."""
    _, tc = _configs(False)
    dts = torch.tensor([0.1, 0.2, 0.3])  # 1-3 s from 25 m: none lands
    sols = TR.scvx_solve(T_STEP, tc, torch.tensor(X0S[:1]).repeat(3, 1), torch.tensor(XT), dts)
    out = TR.scvx_free_time(T_STEP, tc, torch.tensor(X0S[:1]), torch.tensor(XT), dts)
    assert not sols.converged.any()
    assert float(out.dt[0]) == float(dts[sols.defect.argmin()])


def test_simple_scvx_matches_jax():
    jg = JR.SimpleSCVX(J_STEP)
    tg = TR.SimpleSCVX(T_STEP, device="cpu")
    ref = jax.vmap(lambda x: jg.generate(x, jnp.asarray(XT), 0.1, 60))(jnp.asarray(X0S))
    out = tg.generate(torch.tensor(X0S), torch.tensor(XT), 0.1, 60)
    for k in ("X", "U", "fuel_used", "defect"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-4, atol=1e-4)
    assert out.converged.all() and TR.SCVXSolver is TR.scvx_solve


# -- trajectories and the library --------------------------------------------


def _traj(seed, T=8):
    rng = np.random.default_rng(seed)
    times = np.cumsum(np.r_[0.0, rng.uniform(0.05, 0.2, T)]).astype(np.float32)
    X = rng.normal(size=(T + 1, 7)).astype(np.float32)
    U = rng.normal(size=(T, 3)).astype(np.float32)
    return (JR.Trajectory(times=jnp.asarray(times), X=jnp.asarray(X), U=jnp.asarray(U)),
            TR.Trajectory(times=torch.tensor(times), X=torch.tensor(X), U=torch.tensor(U)))


def test_trajectory_interpolation_matches_jax():
    jt, tt = _traj(0)
    ts = np.linspace(-0.1, float(jt.duration) + 0.1, 23).astype(np.float32)
    np.testing.assert_allclose(tt.state_at(torch.tensor(ts)).numpy(),
                               np.asarray(jax.vmap(jt.state_at)(ts)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tt.control_at(torch.tensor(ts)).numpy(),
                                  np.asarray(jax.vmap(jt.control_at)(ts)))
    np.testing.assert_allclose(tt.state_at(0.3).numpy(), np.asarray(jt.state_at(0.3)),
                               rtol=1e-6, atol=1e-6)
    assert float(tt.duration) == float(jt.duration)
    jr, tr = jt.resample(5), tt.resample(5)
    for k in ("times", "X", "U"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   rtol=1e-5, atol=1e-6)


def _libraries(cap=4, T=8):
    jl, tl = JR.TrajectoryLibrary.create(cap, T, 7, 3), TR.TrajectoryLibrary.create(
        cap, T, 7, 3, device="cpu")
    for i in range(cap + 1):  # one more than fits: the ring wraps
        jt, tt = _traj(i, T)
        jl = jl.add(jt, 1.0 + (i * 7) % 5, 0.5 + (i * 3) % 4)
        tl = tl.add(tt, 1.0 + (i * 7) % 5, 0.5 + (i * 3) % 4)
    return jl, tl


def _same_library(tl, jl):
    for name, a, b in zip(("times", "X", "U", "cost", "fuel", "active", "count"),
                          (tl.times, tl.X, tl.U, tl.cost, tl.fuel, tl.active, tl.count),
                          jax.tree.leaves(jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_library_add_get_and_statistics_match_jax():
    jl, tl = _libraries()
    _same_library(tl, jl)
    assert tl.capacity == jl.capacity == 4
    jg, tg = jl.get(2), tl.get(2)
    np.testing.assert_array_equal(tg.X.numpy(), np.asarray(jg.X))
    js, ts = jl.get_statistics(), tl.get_statistics()
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_allclose(np.asarray(ts[k]), np.asarray(js[k]), rtol=1e-6)
    empty = TR.TrajectoryLibrary.create(3, 2, 7, 3, device="cpu").get_statistics()
    assert int(empty["n_trajectories"]) == 0 and math.isinf(float(empty["best_cost"]))


@pytest.mark.parametrize("by", ["cost", "fuel"])
def test_library_queries_match_jax(by):
    jl, tl = _libraries()
    rng = np.random.default_rng(9)
    q = rng.normal(size=(12, 7)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.tensor(weights)
        np.testing.assert_array_equal(tl.nearest(torch.tensor(q), tw).numpy(),
                                      np.asarray(jax.vmap(lambda x: jl.nearest(x, jw))(q)))
        for radius in (0.5, 2.0, 4.0):  # none, some and every state within
            ref = jax.vmap(lambda x: jl.best_within_radius(x, radius, by, jw))(q)
            out = tl.best_within_radius(torch.tensor(q), radius, by, tw)
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(tl.nearest(torch.tensor(q[0]))) == int(jl.nearest(q[0]))


@pytest.mark.parametrize("capacity", [None, 5])
def test_generate_trajectory_library_matches_jax(capacity):
    rng = np.random.default_rng(10)
    X = rng.normal(size=(3, 6, 7)).astype(np.float32)
    U = rng.normal(size=(3, 5, 3)).astype(np.float32)
    cost = rng.uniform(size=3).astype(np.float32)
    jsolve = lambda x0: (jnp.asarray(X)[0] + x0[0], jnp.asarray(U)[0] + x0[1], x0[2], x0[3])
    ref = JR.generate_trajectory_library(jsolve, jnp.asarray(X[:, 0, :4] * 0 + np.c_[
        np.arange(3.0), np.ones(3), cost, cost]), capacity=capacity, dt=0.2)
    x0 = torch.tensor(np.c_[np.arange(3.0), np.ones(3), cost, cost], dtype=torch.float32)
    tsolve = lambda xs: (torch.tensor(X)[0] + xs[:, :1, None], torch.tensor(U)[0] + xs[:, 1:2, None],
                         xs[:, 2], xs[:, 3])
    out = TR.generate_trajectory_library(tsolve, x0, capacity=capacity, dt=0.2)
    _same_library(out, ref)


def test_npz_written_by_each_package_loads_in_the_other(tmp_path):
    jl, tl = _libraries()
    tl.save(str(tmp_path / "port.npz"))
    jl.save(str(tmp_path / "jax.npz"))
    from_port = jl.load(str(tmp_path / "port.npz"))
    from_jax = tl.load(str(tmp_path / "jax.npz"))
    _same_library(from_jax, jl)
    _same_library(tl, from_port)
    assert from_jax.active.dtype == torch.bool and from_jax.count.dtype == torch.int32


def test_reference_exports_the_jax_names():
    assert set(JR.__all__) <= set(TR.__all__)
