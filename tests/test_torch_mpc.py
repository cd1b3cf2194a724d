"""The port's MPC layer against the JAX package on the CPU: chance
tightening helpers, configuration carry-over, and the slice itself — closed-
loop GP-MPC cycles at N=20 in the bench configuration, same GP state and
same initial states in both packages, compared cycle by cycle."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig, RTIConfig as JaxRTIConfig
from gpmpc_tpu.mpc import gp_mpc_init as jax_init, gp_mpc_solve as jax_solve
from gpmpc_tpu.mpc.constraints import normal_quantile as jax_nq
from gpmpc_tpu.mpc.uncertainty_prop import box_tightening as jax_box
from gpmpc_tpu.mpc.uncertainty_prop import propagate_linear as jax_prop
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.gp import Simple3DoFGP
from gpmpc_tpu_torch.mpc import GPMPCConfig, RTIConfig, gp_mpc_init, gp_mpc_solve
from gpmpc_tpu_torch.mpc.constraints import normal_quantile
from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg
from gpmpc_tpu_torch.mpc.uncertainty_prop import box_tightening, gp_process_noise, propagate_linear
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

sys.path.insert(0, "tests")
from test_torch_gp import jax_explore_gp, jax_gp_to_numpy  # noqa: E402

DT = 0.1
N = 20


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _to_numpy_fields(cfg):
    d = _fields(cfg)
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in d.items()}


def jax_bench_config(**kw):
    """bench.py:116-125 (the primary metric's configuration)."""
    return JaxGPMPCConfig(
        base=JaxRTIConfig(
            N=N, accept_pri_tol=1e-2, condensed=True, x_bound_mask=(False,) * 7,
            admm=JaxADMMConfig(max_iter=50, check_interval=50, polish=False,
                               adaptive_rho=False, scaling=2, use_pallas="off",
                               infeas_certs=False, iter_unroll=25),
        ),
        scp_iterations=1, tighten=True, rollout_gp_tape=True,
    ).replace(**kw)


def port_config(jcfg, use_pallas="auto"):
    base = _to_numpy_fields(jcfg.base)
    base["admm"] = _fields(jcfg.base.admm)
    d = _fields(jcfg)
    d["base"] = base
    cfg = convert.gp_mpc_config_from_fields(d, device="cpu")
    return cfg.replace(base=cfg.base.replace(admm=cfg.base.admm.replace(use_pallas=use_pallas)))


def test_normal_quantile_matches_jax():
    c = np.array([0.5, 0.9, 0.95, 0.99], np.float32)
    np.testing.assert_allclose(normal_quantile(torch.tensor(c)).numpy(), jax_nq(jnp.asarray(c)),
                               rtol=1e-5, atol=1e-6)


def test_propagation_and_tightening_match_jax():
    rng = np.random.default_rng(0)
    B, n = 3, 7
    Aks = (np.eye(n) + 0.05 * rng.normal(size=(B, N, n, n))).astype(np.float32)
    means = rng.normal(size=(B, N + 1, n)).astype(np.float32)
    gv = rng.random(size=(B, N, 3)).astype(np.float32)
    S0 = 1e-6 * np.eye(n, dtype=np.float32)
    tp = propagate_linear(torch.tensor(Aks), torch.tensor(means), torch.tensor(S0), torch.tensor(gv), DT)
    tb = box_tightening(tp.covariances, 0.95)
    tk = box_tightening(tp.covariances, 0.95, kappa=torch.tensor(2.0))
    for b in range(B):
        jp = jax_prop(Aks[b], means[b], S0, gv[b], DT)
        # products of 20 near-identity stages in f32
        np.testing.assert_allclose(tp.covariances[b].numpy(), jp.covariances, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(tb[b].numpy(), jax_box(jp.covariances, 0.95), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tk[b].numpy(), jax_box(jp.covariances, 0.95, kappa=2.0),
                                   rtol=1e-5, atol=1e-7)


def test_gp_process_noise_layout():
    v = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    q7 = gp_process_noise(v[:, :3], 7, 0.5)
    assert torch.equal(torch.diagonal(q7[0]), torch.tensor([0, 0, 0, 0, 0.25, 0.5, 0.75]))
    q14 = torch.diagonal(gp_process_noise(v, 14, 1.0)[0])
    assert torch.equal(q14[11:], torch.tensor([4.0, 5.0, 6.0])) and float(q14[:4].sum()) == 0


def test_config_conversion_and_row_structure():
    jcfg = jax_bench_config()
    cfg = port_config(jcfg)
    assert cfg.base.admm.max_iter == 50 and cfg.base.admm.scaling == 2
    assert cfg.base.x_bound_mask == (False,) * 7 and cfg.rollout_gp_tape
    np.testing.assert_array_equal(cfg.base.Q.numpy(), np.asarray(jcfg.base.Q))
    np.testing.assert_array_equal(cfg.base.x_min.numpy(), np.asarray(jcfg.base.x_min))
    # every state row elided: the condensed QP is the 60 identity control rows
    assert _condensed_admm_cfg(cfg.base).row_structure == (("diag", 60),)


def test_gp_mpc_init_matches_jax():
    jcfg = jax_bench_config()
    x0s = np.array([[2.0, 30, 0, 0, -3, 0, 0], [1.9, 33, 1, -1, -2.5, 0.1, 0]], np.float32)
    xT = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)
    st = gp_mpc_init(port_config(jcfg), x0s, xT, device="cpu")
    for b in range(2):
        js = jax_init(jcfg, jnp.asarray(x0s[b]), jnp.asarray(xT))
        for f in ("X_lin", "U_lin", "x_ref", "y_prev"):
            np.testing.assert_allclose(getattr(st, f)[b].numpy(), getattr(js, f), rtol=1e-6, atol=1e-6)
        assert float(st.rho[b]) == pytest.approx(float(js.rho))


@pytest.mark.parametrize("kw", [
    {"warm_kkt": True},
])
def test_gp_mpc_features_outside_the_slice_raise(kw):
    cfg = port_config(jax_bench_config()).replace(**kw)
    with pytest.raises(NotImplementedError):
        gp_mpc_init(cfg, np.zeros((1, 7), np.float32), np.zeros(7, np.float32), device="cpu")


@pytest.mark.parametrize("base_kw", [{"condensed": False}, {"solver": "ipm"}])
def test_gp_mpc_base_options_outside_the_slice_raise(base_kw):
    cfg = port_config(jax_bench_config())
    cfg = cfg.replace(base=cfg.base.replace(**base_kw))
    with pytest.raises(NotImplementedError):
        gp_mpc_init(cfg, np.zeros((1, 7), np.float32), np.zeros(7, np.float32), device="cpu")


def _fleet(B):
    x0s = np.tile(np.array([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0], np.float32), (B, 1))
    x0s[:, 1] += np.linspace(0.0, 5.0, B, dtype=np.float32)
    xT = np.zeros(7, np.float32)
    xT[0] = 2.0
    return x0s, xT


@pytest.fixture(scope="module")
def shared_gp():
    """One JAX-fitted GP (the bench's), and the port's copy of it."""
    gp = jax_explore_gp()
    return gp, convert.simple3dof_gp_from_numpy(jax_gp_to_numpy(gp), device="cpu")


def _run_both(shared_gp, jcfg, use_pallas, cycles, B=8):
    gp, tgp = shared_gp
    jp = JaxParams()
    jpt = jp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    tp = Rocket3DoFParams(device="cpu")
    tpt = tp.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    jF = lambda x, u: jr.step(jp, x, u, DT)
    tF = lambda x, u: tr.step(tp, x, u, DT)
    jmean = lambda x, u: gp.lift_residual(gp.predict_gated(x, u)[0], 7)
    jvar = lambda x, u: gp.predict(x, u)[1]
    tmean = lambda x, u: Simple3DoFGP.lift_residual(tgp.predict_gated(x, u)[0], 7)
    tvar = lambda x, u: tgp.predict(x, u)[1]
    cfg = port_config(jcfg, use_pallas)
    x0s, xT = _fleet(B)
    js = jax.vmap(lambda x: jax_init(jcfg, x, jnp.asarray(xT)))(jnp.asarray(x0s))
    ts = gp_mpc_init(cfg, x0s, xT, device="cpu")
    jstep = jax.jit(lambda s, x: jax.vmap(lambda s, x: jax_solve(jF, jmean, jvar, jcfg, s, x))(s, x))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    out = []
    for _ in range(cycles):
        sj, js = jstep(js, xj)
        st, ts = gp_mpc_solve(tF, tmean, tvar, cfg, ts, xt)
        out.append((sj, st))
        xj = jax.vmap(lambda x, u: jr.step(jpt, x, u, DT))(xj, sj.u0)
        xt = tr.step(tpt, xt, st.u0, DT)
    return out


@pytest.mark.parametrize("use_pallas", ["auto", "off"])
def test_slice_closed_loop_matches_jax(shared_gp, use_pallas):
    """Five closed-loop cycles of the bench configuration at N=20, batch 8:
    u0 and X_opt per cycle within 2e-4, the acceptance flags equal.
    Tolerance: the two packages' f32 Cholesky and reductions differ in the
    last bits; 50 ADMM iterations and the closed loop amplify that to
    ≈7e-5 in u0 by the fifth cycle (the same comparison reaches 4e-4 by
    cycle 20, so longer horizons need a looser bound)."""
    before = K.LAUNCHES
    for k, (sj, st) in enumerate(_run_both(shared_gp, jax_bench_config(), use_pallas, 5)):
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=2e-4, err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=2e-4, err_msg=f"cycle {k}")
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        np.testing.assert_allclose(st.cost.numpy(), sj.cost, rtol=1e-3)
        assert bool(torch.isfinite(st.Sigmas).all())
    assert K.LAUNCHES == before  # CPU tensors run the plain version


@pytest.mark.parametrize("kw", [
    {"rollout_gp_tape": False},
    {"augment_rollout": False},
    {"scp_iterations": 2, "beta_method": "fixed"},
    {"tighten": False, "beta_method": "calibrated"},
])
def test_cycle_variants_match_jax(shared_gp, kw):
    """The other rollout forms, a 2-iteration SCP loop and the β methods:
    one cycle each, same tolerance reasoning as the closed-loop test."""
    (sj, st), = _run_both(shared_gp, jax_bench_config(**kw), "auto", 1, B=4)
    np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=2e-4)
    np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=2e-4)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
