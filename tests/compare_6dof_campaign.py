"""The 6-DoF landing campaign flown by both packages on the CPU, to tell the
controller from the GP when the port's campaign and the JAX package's differ.

With the bench's configuration (``bench.py:345-353``) and the campaign's
initial states (``sample_initial_conditions`` around 20 m), it flies:

1. the JAX package, with its own ``pretrain_gp_6dof`` GP (PRNGKey(42));
2. the port, with that JAX GP carried across by ``convert`` (the same
   controller question on the same GP: outcomes and final states);
3. the port, with its own ``pretrain_gp_6dof`` GP (generator seed 2, as
   ``chip_smoke.py`` draws it).

Run from the repository root (a few minutes at 16 lanes):

    env JAX_PLATFORMS=cpu python tests/compare_6dof_campaign.py --lanes 16 --episodes 4

``--x0 m,h,…`` (14 numbers, repeatable) flies the given initial states
instead, e.g. a lane that did not land in ``chip_smoke.py``'s campaign.

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
sys.path.insert(0, os.path.join(ROOT, "tests"))

from gpmpc_tpu.dynamics import Rocket6DoFParams, rocket6dof as r6  # noqa: E402
from gpmpc_tpu.experiments import (SimulationConfig, campaign_statistics,  # noqa: E402
                                   run_campaign, sample_initial_conditions)
from gpmpc_tpu.learning import pretrain_gp_6dof  # noqa: E402
from gpmpc_tpu.mpc.gp_mpc import make_gp_mpc_controller  # noqa: E402
from gpmpc_tpu.reference import cubic_descent_reference  # noqa: E402
from gpmpc_tpu_torch import convert  # noqa: E402
from gpmpc_tpu_torch.learning import gp_fns  # noqa: E402
from gpmpc_tpu_torch.main_path import fly_sixdof, sixdof_path, sixdof_pretrain_path  # noqa: E402
from test_torch_6dof import jax_bench_6dof_config, jax_sgp_to_numpy  # noqa: E402

DT = 0.1
KEYS = ("success_rate", "landing_speed_mean", "landing_error_mean", "steps_mean")


def _report(name, res, stats, seconds, **extra):
    out = {"flight": name, "lanes": int(res["outcome"].shape[0]), "seconds": seconds,
           **{k: float(stats[k]) for k in KEYS},
           "outcomes": np.asarray(res["outcome"]).tolist(),
           "touchdown_rate": np.linalg.norm(np.asarray(res["x_final"])[:, 11:14], axis=1).tolist(),
           **extra}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--episodes", type=int, default=4, help="pretraining episodes of both GPs")
    ap.add_argument("--x0", action="append", default=None,
                    help="an initial state, 14 comma-separated numbers (repeatable)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    p = Rocket6DoFParams()
    F = lambda x, u: r6.step(p, x, u, DT)
    pt = p.replace(rho=0.8, C_A=0.05 * jnp.eye(3))
    wind = jnp.zeros(14).at[5].set(0.10).at[6].set(0.06)
    plant = lambda x, u: r6.step(pt, x, u, DT) + DT * wind
    gp, mean_fn, var_fn = pretrain_gp_6dof(jax.random.PRNGKey(42), p, plant,
                                           n_episodes=args.episodes)
    xT = r6.create_initial_state(p, altitude=0.0)
    sim = SimulationConfig(max_steps=150, altitude_mean=20.0, altitude_std=2.0)
    if args.x0:
        x0s = jnp.asarray([[float(v) for v in x.split(",")] for x in args.x0], jnp.float32)
    else:
        x0s = sample_initial_conditions(jax.random.PRNGKey(0), sim, args.lanes, n_x=14)
    ci, cs = make_gp_mpc_controller(
        F, mean_fn, var_fn, jax_bench_6dof_config(), xT,
        reference_fn=lambda x0: cubic_descent_reference(x0, xT, 100, DT), ref_horizon=150)
    t0 = time.time()
    ref = jax.jit(lambda xs: run_campaign(ci, cs, plant, xs, sim))(x0s)
    _report("jax, jax GP", ref, campaign_statistics(ref), time.time() - t0)

    sp = sixdof_path("cpu")
    xs = torch.tensor(np.asarray(x0s))
    carried = convert.structured_rocket_gp_from_numpy(jax_sgp_to_numpy(gp), device="cpu")
    t0 = time.time()
    res, stats = fly_sixdof(sp, *gp_fns(carried), xs)
    _report("port, jax GP", res, stats, time.time() - t0,
            same_outcomes=bool((res["outcome"].numpy() == np.asarray(ref["outcome"])).all()),
            max_abs_dx_final=float(np.abs(res["x_final"].numpy() - np.asarray(ref["x_final"])).max()))

    _, pm, pv = sixdof_pretrain_path(torch.Generator().manual_seed(2), "cpu",
                                     n_episodes=args.episodes)
    t0 = time.time()
    res, stats = fly_sixdof(sp, pm, pv, xs)
    _report("port, port GP", res, stats, time.time() - t0)


if __name__ == "__main__":
    main()
