"""How far Path F's controller moves its own u0 under a one-ulp change of the
state, on the CPU, and which part of the cycle amplifies it (not collected
by pytest; the port alone, no JAX):

    python tests/fleet_u0_spread.py --model 6dof --lanes 8

It flies one nominal round of the fleet at ``--lanes`` lanes to fit each
lane's GP, then runs the first cycle of the next round from the fleet's
initial states and from four copies of them scaled by 1 + 1e-7·N(0, 1), and
prints the largest move of u0 for the controller as flown and for four
variants: every GP gated off, no tightening, one SCP iteration, and 400
ADMM iterations instead of 100."""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gpmpc_tpu_torch.learning import run_batched_learning  # noqa: E402
from gpmpc_tpu_torch.learning.batched_learner import (_gated_fns, fleet_cycle,  # noqa: E402
                                                      fleet_reference)
from gpmpc_tpu_torch.main_path import fleet_learning_path, fleet_learning_x0  # noqa: E402
from gpmpc_tpu_torch.mpc import gp_mpc_init  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["3dof", "6dof"], default="6dof")
    ap.add_argument("--lanes", type=int, default=8)
    args = ap.parse_args()
    cpu = torch.device("cpu")
    fp = fleet_learning_path(args.model, cpu)
    x0s = fleet_learning_x0(args.model, torch.Generator().manual_seed(0), None, cpu)[:args.lanes]
    out = run_batched_learning(torch.Generator().manual_seed(1), fp.params, fp.plant, x0s,
                               dataclasses.replace(fp.config, n_rounds=1), fp.mpc, fp.x_target,
                               device=cpu)
    gps, fitted = out["gps"], out["gp_fitted"]
    xr = fleet_reference(x0s, fp.x_target, fp.config, fp.mpc.base.N)
    admm = fp.mpc.base.admm
    variants = {
        "as flown": (fp.mpc, fitted),
        "every GP gated off": (fp.mpc, torch.zeros_like(fitted)),
        "no tightening": (fp.mpc.replace(tighten=False), fitted),
        "one SCP iteration": (fp.mpc.replace(scp_iterations=1), fitted),
        "400 ADMM iterations": (fp.mpc.replace(base=fp.mpc.base.replace(
            admm=dataclasses.replace(admm, max_iter=400))), fitted),
    }
    gen = torch.Generator().manual_seed(0)
    for name, (mpc, use) in variants.items():
        cycle = fleet_cycle(fp.F, fp.plant, mpc, *_gated_fns(gps, use, x0s.shape[-1]), xr)
        st = gp_mpc_init(mpc, x0s, fp.x_target, device=cpu)
        u0 = cycle(st, x0s, 0)[0].u0
        moves = [(cycle(st, x0s * (1 + 1e-7 * torch.randn(x0s.shape, generator=gen)), 0)[0].u0
                  - u0).abs().max().item() for _ in range(4)]
        print(f"{name}: max|du0| over 4 changes of the state "
              f"{[f'{d:.2e}' for d in moves]}, max|u0| {u0.abs().max().item():.3f}")


if __name__ == "__main__":
    main()
