"""Path F's episode cycle in both packages on the CPU, teacher forced on the
JAX plant's states, and how far the port's own u0 moves under a one-ulp
change of the measured state (not collected by pytest):

    env JAX_PLATFORMS=cpu python tests/compare_fleet_cycles.py --model 6dof --cycles 8

Each lane flies with its own GP, fitted in JAX on residuals of the fleet's
plant and carried across (``tests/test_torch_fleet.py``'s helpers). Per
cycle it prints max|Δu0| between the packages for each lane, the solvers'
``success`` and ``converged`` flags in both, and the port's spread: the
largest move of its u0 over three draws of the states scaled by
1 + 1e-7·N(0, 1)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_fleet import (DT, T, JaxS3, JaxSGP, convert, fleet_learning_path,  # noqa: E402
                              fleet_x0, gp_mpc_init, gp_mpc_solve, jax_cdr, jax_fleet,
                              jax_gp_numpy, jax_init, jax_solve, lane_gps)

from gpmpc_tpu_torch.learning.batched_learner import _gated_fns  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["3dof", "6dof"], default="6dof")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=8)
    args = ap.parse_args()
    B, model = args.lanes, args.model
    n_x, cls = (7, JaxS3) if model == "3dof" else (14, JaxSGP)
    _, jfit, _, _, _ = lane_gps(model, B, 0)
    tgp = convert.online_gp_from_numpy(jax_gp_numpy(jfit), device="cpu")
    jf, fp = jax_fleet(model), fleet_learning_path(model, "cpu")
    x0 = fleet_x0(model, B, 1)
    mean_t, var_t = _gated_fns(tgp, torch.ones(B, dtype=torch.bool), n_x)

    def jstep(gp, st, x):
        mean_fn = lambda a, b: cls.lift_residual(gp.predict_gated(a, b)[0], n_x)
        return jax_solve(jf["F"], mean_fn, lambda a, b: gp.predict(a, b)[1], jf["mpc"], st, x)

    jstep = jax.jit(jax.vmap(jstep))
    js = jax.vmap(lambda x: jax_init(jf["mpc"], x, jf["xT"]))(jnp.asarray(x0))
    ts = gp_mpc_init(fp.mpc, x0, fp.x_target, device="cpu")
    ref = np.asarray(jax.vmap(lambda x: jax_cdr(x, jf["xT"], 100, DT))(jnp.asarray(x0)))
    n_win = fp.mpc.base.N + 1
    x = jnp.asarray(x0)
    g = torch.Generator().manual_seed(0)
    np.set_printoptions(formatter={"float": lambda v: f"{v:.2e}"})
    for k in range(args.cycles):
        win = ref[:, k:k + n_win]
        st_in = ts.replace(x_ref=T(win))
        jsol, js = jstep(jfit, js.replace(x_ref=jnp.asarray(win)), x)
        tsol, ts = gp_mpc_solve(fp.F, mean_t, var_t, fp.mpc, st_in, T(x))
        spread = max(float((gp_mpc_solve(fp.F, mean_t, var_t, fp.mpc, st_in,
                                         T(x) * (1 + 1e-7 * torch.randn(x.shape, generator=g)))[0]
                            .u0 - tsol.u0).abs().max()) for _ in range(3))
        du = np.abs(tsol.u0.numpy() - np.asarray(jsol.u0)).max(-1)
        print(f"cycle {k}: max|du0| by lane {du}, success jax {np.asarray(jsol.success)} "
              f"port {tsol.success.numpy()}, converged jax {np.asarray(jsol.converged)} "
              f"port {tsol.converged.numpy()}; the port's own spread {spread:.2e}")
        x = jax.vmap(jf["plant"])(x, jsol.u0)


if __name__ == "__main__":
    main()
