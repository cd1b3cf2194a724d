"""The port's online-learning controller on the 6-DoF model against the JAX
package on the CPU: the structured GP per lane (both stores observed in
lockstep, the novelty gate on the translational features) flown cycle by
cycle in both packages, teacher forced on the JAX package's flown
transitions, through refits every 4 cycles. Inputs come from a numpy seed
and go to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxParams, rocket6dof as jr6
from gpmpc_tpu.learning import OnlineGPMPCConfig as JaxOnlineConfig
from gpmpc_tpu.learning import make_online_gp_mpc_controller as jax_make_online
from gpmpc_tpu.mpc import GPMPCConfig as JaxGPMPCConfig
from gpmpc_tpu.mpc import rti6dof as jrti6
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.reference import cubic_descent_reference as jax_cdr
from gpmpc_tpu_torch.dynamics import Rocket6DoFParams, rocket6dof as tr6
from gpmpc_tpu_torch.gp import StructuredRocketGP
from gpmpc_tpu_torch.learning import OnlineGPMPCConfig, make_online_gp_mpc_controller
from gpmpc_tpu_torch.mpc import GPMPCConfig, rti6dof as trti6
from gpmpc_tpu_torch.ops.qp import ADMMConfig
from gpmpc_tpu_torch.reference import cubic_descent_reference

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
NH = 15
T = lambda a: torch.tensor(np.asarray(a))
ADMM = dict(max_iter=100, check_interval=50, polish=False, adaptive_rho=False, scaling=2,
            infeas_certs=False)
# refits every 4 cycles, the gate open from 6 points, a refresh at k = 9
CADENCE = dict(refit_every=4, refresh_every=10, min_points=6, min_points_hypers=8)


def test_online_cycle_6dof_teacher_forced_matches_jax():
    """12 cycles of the 6-DoF online controller (N = 15, the translation
    bounds elided: n = 45, m = 150, 100 iterations in chunks of 50) at 2
    lanes under the dispersed plant: u0 within 1e-3 each cycle, both stores'
    counts and heads, n_accepted and n_refits exactly, the stores, Z and
    err_hist within 1e-4."""
    jp, tp = JaxParams(), Rocket6DoFParams(device="cpu")
    jpt = jp.replace(rho=0.8, C_A=0.05 * jnp.eye(3))
    wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
    jF = lambda a, b: jr6.step(jp, a, b, DT)
    jF_true = lambda a, b: jr6.step(jpt, a, b, DT) + DT * wind
    xT = np.asarray(jr6.create_initial_state(jp, altitude=0.0))
    jbase = jrti6.rti_config_6dof(jp, N=NH, bound_translation=False,
                                  admm=JaxADMMConfig(use_pallas="off", **ADMM)).replace(
        accept_pri_tol=1e-2, condensed=True)
    tbase = trti6.rti_config_6dof(tp, N=NH, bound_translation=False, admm=ADMMConfig(**ADMM),
                                  device="cpu").replace(accept_pri_tol=1e-2, condensed=True)
    gkw = dict(scp_iterations=1, tighten=True, rollout_gp_tape=True)
    jinit, jstep = jax_make_online(
        jF, JaxOnlineConfig(mpc=JaxGPMPCConfig(base=jbase, **gkw), **CADENCE), jnp.asarray(xT),
        lambda x0: jax_cdr(x0, jnp.asarray(xT), 100, DT), 150, 150)
    tinit, tstep = make_online_gp_mpc_controller(
        lambda a, b: tr6.step(tp, a, b, DT),
        OnlineGPMPCConfig(mpc=GPMPCConfig(base=tbase, **gkw), **CADENCE), xT,
        lambda x0: cubic_descent_reference(x0, T(xT), 100, DT), 150, 150)
    jstep_all = jax.jit(lambda s, x, k: jax.vmap(lambda a, b: jstep(a, b, k))(s, x))
    x0 = np.tile(np.asarray(jr6.create_initial_state(jp, altitude=0.0, velocity=(-2.0, 0.1, 0.0))),
                 (2, 1))
    x0[:, 1] = [17.0, 21.5]
    x0[:, 2:4] = [[0.4, -0.3], [-0.6, 0.2]]
    xs = jnp.asarray(x0)
    js, ts = jax.vmap(jinit)(xs), tinit(T(x0))
    assert isinstance(ts.gp, StructuredRocketGP) and ts.gp.lanes == 2
    assert ts.mpc.y_prev.shape == js.mpc.y_prev.shape == (2, 150)
    for k in range(12):
        uj, js = jstep_all(js, xs, jnp.asarray(k, jnp.int32))
        ut, ts = tstep(ts, T(xs), k)
        msg = f"cycle {k}"
        np.testing.assert_allclose(ut.numpy(), uj, atol=1e-3, err_msg=msg)
        ts = dataclasses.replace(ts, u_prev=T(uj))  # the flown transition is JAX's
        for tb, jb, tg, jg in ((ts.gp.trans_buffer, js.gp.trans_buffer, ts.gp.trans_gp,
                                js.gp.trans_gp),
                               (ts.gp.rot_buffer, js.gp.rot_buffer, ts.gp.rot_gp, js.gp.rot_gp)):
            np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count), err_msg=msg)
            np.testing.assert_array_equal(tb.head.numpy(), np.asarray(jb.head), err_msg=msg)
            np.testing.assert_allclose(tb.X.numpy(), jb.X, atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(tb.Y.numpy(), jb.Y, atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(tg.Z.numpy(), jg.Z, atol=1e-4, err_msg=msg)
        for name in ("n_accepted", "n_refits"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                          err_msg=f"{msg} {name}")
        np.testing.assert_allclose(ts.err_hist.numpy(), js.err_hist, atol=1e-4, err_msg=msg)
        xs = jax.vmap(jF_true)(xs, uj)
    # refits at k = 3, 7 and 11, the refresh at k = 9
    assert ts.n_refits.tolist() == [4, 4] and ts.gp.buffer_count.tolist() == [11, 11]
    torch.testing.assert_close(ts.gp.trans_buffer.count, ts.gp.rot_buffer.count)
