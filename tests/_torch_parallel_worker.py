"""One rank of the port's multi-process tests (``tests/test_torch_parallel.py``).

Runs ``gpmpc_tpu_torch.parallel`` for real on a gloo process group on the
CPU, one process per rank, and writes what each rank computed to
``<dir>/rank<r>.pt``; the tests compare those files with the JAX package
and with each other. Inputs come from ``<dir>/inputs.pt`` (NumPy arrays,
made by the test from a seed).

Usage: _torch_parallel_worker.py <mode: world|pair> <rank> <world> <port> <dir>
"""

import os
import sys

mode, rank, world, port, out_dir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4], sys.argv[5])

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from gpmpc_tpu_torch import convert  # noqa: E402
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as r3  # noqa: E402
from gpmpc_tpu_torch.experiments import (SimulationConfig, campaign_statistics,  # noqa: E402
                                         run_campaign)
from gpmpc_tpu_torch.parallel import (broadcast_from_host0, gather_safe_sets_global,  # noqa: E402
                                      hosts_chips_mesh, initialize_distributed, replicate,
                                      run_sharded_campaign, scenario_mesh, shard_over_mesh,
                                      shard_scenarios, sharded_campaign_statistics)
from gpmpc_tpu_torch.terminal import SafeSet  # noqa: E402
from gpmpc_tpu_torch.terminal.safe_set import merge_safe_sets  # noqa: E402

CAP = 32
FIELDS = ("outcome", "fuel_used", "landing_speed", "landing_error", "steps")


def descent_controller(p):
    """``tests/test_parallel.py::descent_controller``, lanes first."""
    p_clamp = p.replace(T_min=0.0, T_max=5.0)

    def cinit(x0):
        return x0.new_zeros(x0.shape[0], 0)

    def cstep(c, x, k):
        v_ref = -0.8 * torch.sqrt(x[:, 1].clamp_min(0.0))
        u = r3.hover_thrust(p, x) + torch.stack(
            [2.0 * (v_ref - x[:, 4]), -1.0 * x[:, 5] - 0.5 * x[:, 2],
             -1.0 * x[:, 6] - 0.5 * x[:, 3]], dim=-1)
        return r3.clamp_thrust(p_clamp, u), c

    return cinit, cstep


def make_host_set(seed: int) -> SafeSet:
    """``tests/_mp_worker.py::make_host_set`` in the port: every rank can
    rebuild every rank's set."""
    rng = np.random.default_rng(seed)
    ss = SafeSet.create(CAP, 7, device="cpu")
    for _ in range(2):
        X = torch.tensor(rng.normal(size=(8, 7)), dtype=torch.float32)
        U = torch.tensor(rng.normal(size=(8, 3)), dtype=torch.float32)
        c = torch.tensor(rng.uniform(1.0, 2.0, size=(8,)), dtype=torch.float32)
        ss = ss.add_trajectory(X, U, c)
    return ss


def stats_numpy(stats):
    out = {k: float(v) for k, v in stats.items() if k not in ("success_ci", "outcome_counts")}
    out["success_ci"] = [float(v) for v in stats["success_ci"]]
    out["outcome_counts"] = {k: int(v) for k, v in stats["outcome_counts"].items()}
    return out


def collectives(out):
    """The ``tests/_mp_worker.py`` checks: the global safe-set gather and the
    rank-0 broadcast, with what each should give."""
    merged = gather_safe_sets_global(make_host_set(100 + rank), capacity=CAP)
    expected = merge_safe_sets([make_host_set(100 + i) for i in range(world)], capacity=CAP)
    out["gather"] = {k: getattr(merged, k) for k in ("states", "q_values", "controls",
                                                     "fuel_required", "traj_ids", "count",
                                                     "n_trajectories")}
    out["gather_expected"] = {k: getattr(expected, k) for k in out["gather"]}
    tree = {"a": torch.arange(4.0) + 100.0 * rank, "b": torch.tensor(rank, dtype=torch.int32),
            "set": make_host_set(200 + rank), "flag": torch.tensor([rank == 0, rank != 0])}
    got = broadcast_from_host0(tree)
    out["broadcast"] = {"a": got["a"], "b": got["b"], "flag": got["flag"],
                        "set_states": got["set"].states,
                        "set_expected": make_host_set(200).states}


def main():
    assert initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    out = {"rank": rank}
    collectives(out)
    if mode == "world":
        inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
        p = Rocket3DoFParams(device="cpu")
        cinit, cstep = descent_controller(p)

        # the 1-D scenario mesh: the sharded descent campaign
        mesh = scenario_mesh()
        out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
        sim = SimulationConfig(max_steps=200, altitude_mean=15.0, altitude_std=1.0)
        plant = lambda x, u: r3.step(p, x, u, sim.dt)
        x0s = torch.tensor(inp["x0s"])
        res = run_sharded_campaign(mesh, cinit, cstep, plant, x0s, sim)
        out["descent"] = {"lanes": (res["lanes"].start, res["lanes"].stop),
                          "results": {k: res["results"][k] for k in FIELDS + ("x_final",)},
                          "stats": stats_numpy(res["stats"])}
        if rank == 0:
            ref = run_campaign(cinit, cstep, plant, x0s, sim)
            out["descent_unsharded"] = {k: ref[k] for k in FIELDS + ("x_final",)}
        try:
            run_sharded_campaign(mesh, cinit, cstep, plant, torch.zeros(12, 7),
                                 SimulationConfig(max_steps=10))
            out["divide_error"] = None
        except ValueError as e:
            out["divide_error"] = str(e)

        # placements: Shard(0) and Replicate() DTensors round-trip
        dt = shard_scenarios(mesh, {"x": x0s})["x"]
        rep = replicate(mesh, {"x": x0s})["x"]
        out["dtensor"] = {"local": tuple(dt.to_local().shape), "full": dt.full_tensor(),
                          "replicated": rep.full_tensor(),
                          "placements": [(type(p).__name__, p.dim) for p in dt.placements]}

        # the ("hosts", "chips") meshes: one host, then 2 x 4 by LOCAL_WORLD_SIZE
        out["hosts_chips"] = tuple(hosts_chips_mesh().mesh.shape)
        os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
        mesh24 = hosts_chips_mesh()
        out["hosts_chips_24"] = (mesh24.mesh_dim_names, tuple(mesh24.mesh.shape))
        sim180 = SimulationConfig(max_steps=180, altitude_mean=15.0, altitude_std=1.0)
        full = run_campaign(cinit, cstep, plant, x0s, sim180)
        sharded = shard_over_mesh(mesh24, {k: full[k] for k in FIELDS})
        out["stats24_placements"] = [(type(p).__name__, p.dim)
                                     for p in sharded["outcome"].placements]
        out["stats24"] = stats_numpy(sharded_campaign_statistics(mesh24, sharded))
        out["stats24_local"] = stats_numpy(campaign_statistics(full))

        # a small GP-MPC campaign (tests/test_parallel.py's real-controller twin)
        from gpmpc_tpu_torch.gp import Simple3DoFGP
        from gpmpc_tpu_torch.mpc import GPMPCConfig, RTIConfig, make_gp_mpc_controller
        from gpmpc_tpu_torch.ops.qp import ADMMConfig

        gp = convert.simple3dof_gp_from_numpy(inp["gp"], device="cpu")
        p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
        F = lambda x, u: r3.step(p, x, u, 0.1)
        F_true = lambda x, u: r3.step(p_true, x, u, 0.1)
        mean_fn = lambda x, u: Simple3DoFGP.lift_residual(gp.predict_gated(x, u)[0], 7)
        var_fn = lambda x, u: gp.predict(x, u)[1]
        cfg = GPMPCConfig(base=RTIConfig(N=10, accept_pri_tol=5e-3, condensed=True,
                                         admm=ADMMConfig(max_iter=50, polish=False,
                                                         adaptive_rho=False, scaling=3),
                                         device="cpu"),
                          scp_iterations=2, tighten=True)
        xT = torch.zeros(7)
        xT[0] = 2.0
        gc, gs = make_gp_mpc_controller(F, mean_fn, var_fn, cfg, xT)
        sim40 = SimulationConfig(max_steps=40, altitude_mean=12.0, altitude_std=1.0)
        x0g = torch.tensor(inp["x0s_gp"])
        gres = run_sharded_campaign(mesh, gc, gs, F_true, x0g, sim40)
        out["gpmpc"] = {"lanes": (gres["lanes"].start, gres["lanes"].stop),
                        "results": {k: gres["results"][k] for k in ("outcome", "x_final")}}
        if rank == 0:
            ref = run_campaign(gc, gs, F_true, x0g, sim40)
            out["gpmpc_unsharded"] = {k: ref[k] for k in ("outcome", "x_final")}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print(f"TORCH_MP_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
