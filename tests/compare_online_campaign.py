"""The online-learning campaigns flown by both packages on the CPU, to tell a
fault of the port from a lane that the reference controller loses too.

With the campaign script's configuration (``scripts/run_campaign_tpu.py
--controller online_gp_mpc --elide``, ``--model 3dof``: 130 steps from 30 m,
drag and wind; ``--model 6dof``: 150 steps from 20 m, Path D's plant) and
its initial states (``sample_initial_conditions(PRNGKey(0))``), it flies:

1. the JAX package's online controller, every lane from an empty GP;
2. the port's (``main_path.online_flight_path`` and ``fly_online``) on the
   same initial states.

Run from the repository root (a few minutes at 16 lanes):

    env JAX_PLATFORMS=cpu python tests/compare_online_campaign.py --model 3dof --lanes 16

``--x0 m,h,…`` (7 or 14 numbers, repeatable) flies the given initial states
instead, e.g. the lanes that did not land in ``chip_smoke.py``'s campaign.

Prints one JSON line per flight. Not collected by pytest.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpmpc_tpu.dynamics import Rocket3DoFParams, Rocket6DoFParams  # noqa: E402
from gpmpc_tpu.dynamics import rocket3dof as r3, rocket6dof as r6  # noqa: E402
from gpmpc_tpu.experiments import (SimulationConfig, campaign_statistics,  # noqa: E402
                                   run_campaign, sample_initial_conditions)
from gpmpc_tpu.learning import (OnlineGPMPCConfig, make_online_gp_mpc_controller,  # noqa: E402
                                online_controller_info)
from gpmpc_tpu.mpc import GPMPCConfig, RTIConfig, rti_config_6dof  # noqa: E402
from gpmpc_tpu.ops.qp import ADMMConfig  # noqa: E402
from gpmpc_tpu.reference import cubic_descent_reference  # noqa: E402
from gpmpc_tpu_torch.main_path import fly_online, learning_trace, online_flight_path  # noqa: E402

DT = 0.1
KEYS = ("success_rate", "landing_speed_mean", "landing_error_mean", "steps_mean")
ADMM = dict(max_iter=50, check_interval=50, polish=False, adaptive_rho=False, scaling=2,
            use_pallas="off", infeas_certs=False)


def jax_online_campaign(model: str):
    """(cinit, cstep, plant, sim) of the JAX package's online campaign."""
    if model == "3dof":
        p = Rocket3DoFParams()
        F = lambda x, u: r3.step(p, x, u, DT)
        pt = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
        wind = jnp.zeros(7).at[5].set(0.4).at[6].set(0.25)
        plant = lambda x, u: r3.step(pt, x, u, DT) + DT * wind
        xT = jnp.zeros(7).at[0].set(2.0)
        base = RTIConfig(N=20, accept_pri_tol=1e-2, condensed=True, x_bound_mask=(False,) * 7,
                         admm=ADMMConfig(**ADMM))
        sim = SimulationConfig(max_steps=130, altitude_mean=30.0, altitude_std=2.0)
    else:
        p = Rocket6DoFParams()
        F = lambda x, u: r6.step(p, x, u, DT)
        pt = p.replace(rho=0.8, C_A=0.05 * jnp.eye(3))
        wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
        plant = lambda x, u: r6.step(pt, x, u, DT) + DT * wind
        xT = r6.create_initial_state(p, altitude=0.0)
        base = rti_config_6dof(p, N=20, bound_translation=False,
                               admm=ADMMConfig(**{**ADMM, "max_iter": 100})).replace(
            accept_pri_tol=1e-2, condensed=True)
        sim = SimulationConfig(max_steps=150, altitude_mean=20.0, altitude_std=2.0)
    cfg = OnlineGPMPCConfig(mpc=GPMPCConfig(base=base, scp_iterations=1, tighten=True,
                                            rollout_gp_tape=True))
    steps = sim.max_steps
    cinit, cstep = make_online_gp_mpc_controller(
        F, cfg, xT, lambda x0: cubic_descent_reference(x0, xT, 100, DT), steps, steps)
    return cinit, cstep, plant, sim


def _report(name, res, stats, steps, seconds, **extra):
    x_final = np.asarray(res["x_final"])
    trace = learning_trace(torch.tensor(np.asarray(res["err_hist"])), steps)
    out = {"flight": name, "lanes": int(x_final.shape[0]), "seconds": seconds,
           **{k: float(stats[k]) for k in KEYS},
           "model_err_reduction_x": trace["model_err_reduction_x"],
           "outcomes": np.asarray(res["outcome"]).tolist(),
           "steps": np.asarray(res["steps"]).tolist(),
           "final_altitude": x_final[:, 1].round(4).tolist(),
           "final_position_error": np.linalg.norm(x_final[:, 2:4], axis=1).round(4).tolist(),
           **extra}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["3dof", "6dof"], default="3dof")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--x0", action="append", default=None,
                    help="an initial state, comma-separated numbers (repeatable)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    cinit, cstep, plant, sim = jax_online_campaign(args.model)
    n_x = 7 if args.model == "3dof" else 14
    if args.x0:
        x0s = jnp.asarray([[float(v) for v in x.split(",")] for x in args.x0], jnp.float32)
    else:
        x0s = sample_initial_conditions(jax.random.PRNGKey(0), sim, args.lanes, n_x=n_x)
    t0 = time.time()
    ref = jax.device_get(jax.jit(lambda xs: run_campaign(
        cinit, cstep, plant, xs, sim, cstate_info=online_controller_info))(x0s))
    _report("jax", ref, campaign_statistics({k: jnp.asarray(v) for k, v in ref.items()}),
            sim.max_steps, time.time() - t0)

    t0 = time.time()
    res, stats, _ = fly_online(online_flight_path(args.model, "cpu"),
                               torch.tensor(np.asarray(x0s)))
    _report("port", res, stats, sim.max_steps, time.time() - t0,
            same_outcomes=bool((res["outcome"].numpy() == np.asarray(ref["outcome"])).all()),
            max_abs_dx_final=float(np.abs(res["x_final"].numpy() - np.asarray(ref["x_final"])).max()))


if __name__ == "__main__":
    main()
