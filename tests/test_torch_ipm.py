"""The port's interior-point QP solver (``gpmpc_tpu_torch/ops/qp/ipm.py``)
against the JAX package's ``solve_ipm`` and the independent float64 IPM
oracle (``tests/_oracles.py::ipm_solve``) on ``tests/test_ipm.py``'s random
feasible QPs, lane independence and the freeze of a lane whose normal
equations lose definiteness, and ``solver="ipm"`` in the RTI and GP-MPC
cycles at the bench's settings (``bench.py:126-129``, ``ipm_iters=10``)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.mpc import rti as JR
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.ops.qp import IPMConfig as JaxIPMConfig, QPData as JaxQPData
from gpmpc_tpu.ops.qp import solve_ipm as jax_solve_ipm
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.mpc import rti as TR
from gpmpc_tpu_torch.ops.qp import SOLVED, IPMConfig, QPData, solve_ipm

sys.path.insert(0, "tests")
from _oracles import ipm_solve as oracle_ipm  # noqa: E402
from test_ipm import _random_feasible_qp  # noqa: E402
from test_torch_mpc import jax_bench_config  # noqa: E402
from test_torch_gp import jax_explore_gp  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores


def _port(qps):
    """f32 lane-batched QPData from float64 (P, q, A, l, u) tuples."""
    return QPData(*[torch.tensor(np.stack([qp[i] for qp in qps]), dtype=torch.float32)
                    for i in range(5)])


def _jax(qp):
    return JaxQPData(*[jnp.asarray(v, jnp.float32) for v in qp])


@pytest.mark.parametrize("seed,n_eq", [(0, 3), (1, 3), (2, 3), (7, 0)])
def test_single_qp_matches_jax_and_oracle(seed, n_eq):
    """tests/test_ipm.py:63: x within 2e-3 of the float64 optimum; the same
    bound against the JAX solver's f32 iterate, and the same status."""
    qp = _random_feasible_qp(seed, n_eq=n_eq)
    sol = solve_ipm(_port([qp]), IPMConfig(n_eq=n_eq, iters=25))
    jsol = jax_solve_ipm(_jax(qp), JaxIPMConfig(n_eq=n_eq, iters=25))
    x_ref, info = oracle_ipm(*qp)
    assert int(sol.status[0]) == SOLVED == int(jsol.status)
    np.testing.assert_allclose(sol.x[0].numpy(), x_ref, atol=2e-3)
    np.testing.assert_allclose(sol.x[0].numpy(), np.asarray(jsol.x), atol=2e-3)
    assert float(sol.pri_res[0]) <= 2e-3 * (1 + np.abs(qp[2] @ x_ref).max())
    assert bool(torch.isfinite(sol.y).all())


def test_batched_qps_match_jax_vmap_and_oracle():
    """tests/test_ipm.py:92: every lane within 4e-3 of its float64 optimum
    (the measured f32 primal floor across seeds, batched), in both packages;
    so the two f32 iterates lie within twice that of each other (seed 12:
    port 1.7e-3 and JAX 2.6e-3 from the optimum on opposite sides, 4.0e-3
    apart)."""
    qps = [_random_feasible_qp(s) for s in (10, 11, 12, 13)]
    sol = solve_ipm(_port(qps), IPMConfig(n_eq=3, iters=25))
    cfg = JaxIPMConfig(n_eq=3, iters=25)
    jsol = jax.vmap(lambda d: jax_solve_ipm(d, cfg))(
        JaxQPData(*[jnp.stack([jnp.asarray(qp[i], jnp.float32) for qp in qps]) for i in range(5)]))
    for i, qp in enumerate(qps):
        assert int(sol.status[i]) == SOLVED == int(jsol.status[i])
        x_ref = oracle_ipm(*qp)[0]
        np.testing.assert_allclose(sol.x[i].numpy(), x_ref, atol=4e-3)
        np.testing.assert_allclose(np.asarray(jsol.x[i]), x_ref, atol=4e-3)
        np.testing.assert_allclose(sol.x[i].numpy(), np.asarray(jsol.x[i]), atol=8e-3)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))


def test_lanes_are_independent():
    """A lane's solve does not depend on its neighbours: alone, beside other
    QPs and beside a copy of itself, the same status and x (the duplicate
    lanes bit for bit)."""
    qps = [_random_feasible_qp(s) for s in range(4)]
    cfg = IPMConfig(n_eq=3, iters=25)
    batch = solve_ipm(_port(qps + [qps[0]]), cfg)
    for i, qp in enumerate(qps):
        alone = solve_ipm(_port([qp]), cfg)
        assert int(alone.status[0]) == int(batch.status[i])
        np.testing.assert_allclose(batch.x[i].numpy(), alone.x[0].numpy(), atol=2e-3)
    np.testing.assert_array_equal(batch.x[0].numpy(), batch.x[4].numpy())


def test_lane_that_loses_definiteness_freezes():
    """A negative-definite P makes the normal-equations matrix indefinite:
    that lane's Cholesky reports failure, its factor turns NaN, its iterate
    freezes finite and unsolved with no iteration used, and the other lanes
    are exactly what they are without it. Nothing raises."""
    qps = [_random_feasible_qp(s) for s in (0, 1)]
    bad = list(_random_feasible_qp(2))
    bad[0] = -1e3 * np.eye(bad[0].shape[0])
    cfg = IPMConfig(n_eq=3, iters=25)
    sol = solve_ipm(_port([qps[0], bad, qps[1]]), cfg)
    ref = solve_ipm(_port(qps), cfg)
    assert bool(torch.isfinite(sol.x).all()) and bool(torch.isfinite(sol.y).all())
    assert int(sol.iterations[1]) == 0 and int(sol.status[1]) != SOLVED
    np.testing.assert_array_equal(sol.x[1].numpy(), np.zeros(bad[0].shape[0], np.float32))
    for i, j in ((0, 0), (2, 1)):
        np.testing.assert_array_equal(sol.x[i].numpy(), ref.x[j].numpy())
        assert int(sol.status[i]) == int(ref.status[j]) == SOLVED


# -- solver="ipm" in the cycles ----------------------------------------------------

N = 20


def _rti_configs():
    """The bench's RTI configuration (bench.py:110-115) with its IPM arm
    (bench.py:126-127)."""
    jcfg = JR.RTIConfig(
        N=N, accept_pri_tol=5e-3, condensed=True, x_bound_mask=(False,) * 7,
        admm=JaxADMMConfig(max_iter=50, polish=False, adaptive_rho=False, scaling=2,
                           use_pallas="off"),
    ).replace(solver="ipm", ipm_iters=10)
    d = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in d.items()}
    d["admm"] = {f: getattr(jcfg.admm, f) for f in jcfg.admm.__dataclass_fields__}
    return jcfg, convert.rti_config_from_fields(d, device="cpu")


def test_rti_cycle_with_ipm_matches_jax():
    """Three closed-loop RTI cycles of 4 lanes on the IPM arm: u0 within
    5e-3 of JAX's (the LMPC tolerance, tests/test_lmpc.py:123), the same
    acceptance, and the ADMM carry (ρ, duals) untouched in both."""
    from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr

    jcfg, cfg = _rti_configs()
    assert cfg.solver == "ipm" and cfg.ipm_iters == 10
    jp, tp = JaxParams(), Rocket3DoFParams(device="cpu")
    jF = lambda x, u: jr.step(jp, x, u, 0.1)
    tF = lambda x, u: tr.step(tp, x, u, 0.1)
    x0s = np.tile(np.array([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0], np.float32), (4, 1))
    x0s[:, 1] += np.linspace(0.0, 5.0, 4, dtype=np.float32)
    xT = np.zeros(7, np.float32)
    xT[0] = 2.0
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(xT)))(jnp.asarray(x0s))
    ts = TR.rti_init(cfg, x0s, xT)
    jstep = jax.jit(jax.vmap(lambda s, x: JR.rti_step(jF, jcfg, s, x)))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    for k in range(3):
        sj, js = jstep(js, xj)
        rho0, y0 = ts.rho, ts.y_prev
        st, ts = TR.rti_step(tF, cfg, ts, xt)
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-3, err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        assert torch.equal(ts.rho, rho0) and torch.equal(ts.y_prev, y0)
        xj, xt = jax.vmap(jF)(xj, sj.u0), tF(xt, st.u0)


def test_sparse_rti_rejects_ipm():
    """As in the JAX package: the sparse form's interleaved equality rows
    do not meet the IPM contract."""
    _, cfg = _rti_configs()
    cfg = cfg.replace(condensed=False)
    x0s = np.array([[2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0]], np.float32)
    st = TR.rti_init(cfg, x0s, x0s[0] * 0)
    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr

    with pytest.raises(ValueError, match="condensed"):
        TR.rti_step(lambda x, u: tr.step(Rocket3DoFParams(device="cpu"), x, u, 0.1), cfg, st,
                    torch.tensor(x0s))


def test_gp_mpc_cycle_with_ipm_matches_jax():
    """Five cycles of the bench's GP-MPC configuration on its IPM arm
    (bench.py:128-129) with the bench's GP, 4 lanes, teacher forced: both
    packages solve from JAX's warm-start state and JAX's flown states. u0
    within 5e-3 of JAX's (the LMPC tolerance, tests/test_lmpc.py:123), the
    same acceptance, the ADMM carry untouched. (Flown apart, 10 IPM
    iterations let the two closed loops drift 2.4e-2 apart by cycle 3.)"""
    from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
    from gpmpc_tpu.mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
    from gpmpc_tpu_torch.gp import Simple3DoFGP
    from gpmpc_tpu_torch.mpc import GPMPCState, gp_mpc_solve
    from test_torch_gp import jax_gp_to_numpy
    from test_torch_mpc import _fleet, port_config

    gp = jax_explore_gp()
    tgp = convert.simple3dof_gp_from_numpy(jax_gp_to_numpy(gp), device="cpu")
    jcfg = jax_bench_config()
    jcfg = jcfg.replace(base=jcfg.base.replace(solver="ipm", ipm_iters=10))
    cfg = port_config(jcfg)
    assert cfg.base.solver == "ipm" and cfg.base.ipm_iters == 10
    jp, tp = JaxParams(), Rocket3DoFParams(device="cpu")
    jpt = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    jF = lambda x, u: jr.step(jp, x, u, 0.1)
    tF = lambda x, u: tr.step(tp, x, u, 0.1)
    jmean = lambda x, u: gp.lift_residual(gp.predict_gated(x, u)[0], 7)
    jvar = lambda x, u: gp.predict(x, u)[1]
    tmean = lambda x, u: Simple3DoFGP.lift_residual(tgp.predict_gated(x, u)[0], 7)
    tvar = lambda x, u: tgp.predict(x, u)[1]
    x0s, xT = _fleet(4)
    js = jax.vmap(lambda x: jax_init(jcfg, x, jnp.asarray(xT)))(jnp.asarray(x0s))
    jstep = jax.jit(jax.vmap(lambda s, x: jax_solve(jF, jmean, jvar, jcfg, s, x)))
    xj = jnp.asarray(x0s)
    fields = ("X_lin", "U_lin", "x_ref", "rho", "y_prev")
    for k in range(5):
        ts = GPMPCState(**{f: torch.tensor(np.asarray(getattr(js, f))) for f in fields})
        st, ts2 = gp_mpc_solve(tF, tmean, tvar, cfg, ts, torch.tensor(np.asarray(xj)))
        sj, js = jstep(js, xj)
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-3, err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        assert torch.equal(ts2.rho, ts.rho) and torch.equal(ts2.y_prev, ts.y_prev)
        xj = jax.vmap(lambda x, u: jr.step(jpt, x, u, 0.1))(xj, sj.u0)
