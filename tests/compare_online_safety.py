"""The online safety campaign (``scripts/run_online_safety_tpu.py
--filter-model gp --filter-n 8``: online GP-MPC behind the funnel filter
that reads each lane's learned GP, gust -1.5, 110 steps) flown on the CPU
by the JAX package, by the port, or by both, on the same initial states,
for as many episodes as asked, with the GP carried between them.

It tells the algorithm from the port when the card's campaign fails its
gate: a lane that degrades in both packages degrades by the algorithm, and
two runs of one package on two platforms part lane by lane where f32 noise
flips a borderline outcome, so the comparison is of the campaign's
statistics and of which lanes degrade.

The initial states (``--draw``):

- ``artifact``: ``tests/fixtures/safety_x0.npz`` "online", the states the
  JAX package's artifact flew (``PRNGKey(11)``);
- ``card``: ``tests/fixtures/online_safety_card_draw.npz``, the states the
  port's ``sample_initial_conditions`` drew on an H100 from a CUDA generator
  seeded 11 (CUDA's generator cannot be replayed on the CPU).

Run from the repository root, e.g. (512 lanes and 6 episodes take ~25 min
a package on 4 CPU threads):

    env JAX_PLATFORMS=cpu python tests/compare_online_safety.py --draw card \\
        --package jax --out build/online_safety_jax_card.json
    env JAX_PLATFORMS=cpu python tests/compare_online_safety.py --draw artifact \\
        --lanes 394,196,477 --package both

Prints, for each package, one JSON line per episode (success, landed, lanes
whose state is not finite, interventions) and one summary line (the McNemar
z of each episode's success against the first, the script's gate, the lanes
that degraded and improved); ``--out`` also writes every lane's outcomes.
Not collected by pytest.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

DRAWS = {"artifact": "safety_x0.npz", "card": "online_safety_card_draw.npz"}


def fly_jax(x0s, episodes):
    """The script's composition and episode loop (``:160-200``) in the JAX
    package; per lane and episode: success, interventions, final state."""
    import jax
    import jax.numpy as jnp
    from gpmpc_tpu.learning import carry_gp_between_episodes
    from test_torch_safety import _jax_online_safety

    cinit, finit, fstep, plant, _ = _jax_online_safety()

    def episode(fs, x0):
        def body(carry, k):
            x, s = carry
            u, s = fstep(s, x, k)
            return (jnp.where(x[1] <= 0.1, x, plant(x, u)), s), None

        (xf, fs), _ = jax.lax.scan(body, (x0, fs), jnp.arange(110))
        return fs, {"x_final": xf, "interventions": fs[1]}

    @jax.jit
    def fly(x0s):
        def lane(x0):
            fs, out = finit(x0), []
            for e in range(episodes):
                if e:
                    fs = (carry_gp_between_episodes(cinit, fs[0], x0),) + tuple(
                        jnp.zeros_like(s) for s in fs[1:])
                fs, st = episode(fs, x0)
                out.append(st)
            return jax.tree.map(lambda *a: jnp.stack(a), *out)

        return jax.vmap(lane)(x0s)

    r = jax.device_get(fly(jnp.asarray(x0s)))
    return np.asarray(r["x_final"], np.float64), np.asarray(r["interventions"])


def fly_port(x0s, episodes, threads):
    """``main_path.online_safety_path("cpu")`` flown as
    ``fly_online_safety`` flies it, keeping every lane's outcome."""
    from gpmpc_tpu_torch.learning import carry_gp_between_episodes
    from gpmpc_tpu_torch.main_path import online_safety_path

    torch.set_num_threads(threads)  # after test_torch_safety's import pins it to one
    op = online_safety_path("cpu")
    finit, fstep = op.controller
    x0 = torch.tensor(x0s)
    xf, ints, fs = [], [], None
    for _ in range(episodes):
        fs = finit(x0) if fs is None else (carry_gp_between_episodes(op.inner[0], fs[0], x0),) + \
            tuple(torch.zeros_like(s) for s in fs[1:])
        x = x0
        for k in range(op.sim.max_steps):
            u, fs = fstep(fs, x, k)
            x = torch.where((x[:, 1] <= 0.1)[:, None], x, op.plant(x, u))
        xf.append(x.double().numpy())
        ints.append(fs[1].numpy())
    return np.stack(xf, 1), np.stack(ints, 1)


def summarise(package, lanes, x_final, interventions, seconds):
    """The script's statistics (``:203-293``) from per-lane outcomes."""
    finite = np.isfinite(x_final).all(-1)
    alt = np.where(finite, x_final[..., 1], np.inf)
    landed = alt <= 0.1
    speed = np.linalg.norm(np.where(finite[..., None], x_final[..., 4:7], np.inf), axis=-1)
    success = landed & (speed <= 2.0)
    E = success.shape[1]
    for e in range(E):
        print(json.dumps({"package": package, "episode": e + 1,
                          "success_rate": float(success[:, e].mean()),
                          "landed_rate": float(landed[:, e].mean()),
                          "nonfinite_lanes": int((~finite[:, e]).sum()),
                          "interventions_mean": float(interventions[:, e].mean())}), flush=True)
    z = []
    for e in range(1, E):
        b = float((success[:, 0] & ~success[:, e]).sum())
        c = float((~success[:, 0] & success[:, e]).sum())
        z.append((b - c) / max((b + c) ** 0.5, 1.0))
    ints = interventions.mean(0)
    gate = bool(ints[-1] < ints[0] and success[:, -1].mean() > 0.95 and all(v < 2.0 for v in z))
    degraded = [int(lanes[i]) for i in range(len(lanes)) if success[i, 0] and not success[i].all()]
    improved = [int(lanes[i]) for i in range(len(lanes)) if not success[i, 0] and success[i].any()]
    print(json.dumps({"package": package, "lanes": len(lanes), "episodes": E, "seconds": seconds,
                      "success_mcnemar_z_vs_ep1": z, "gate": gate, "degraded": degraded,
                      "improved": improved}), flush=True)
    return {"lanes": [int(i) for i in lanes], "success": success.astype(int).tolist(),
            "interventions": interventions.astype(int).tolist(),
            "altitude": np.where(finite, x_final[..., 1], np.nan).tolist(),
            "finite": finite.astype(int).tolist(), "mcnemar_z": z, "gate": gate}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draw", choices=sorted(DRAWS), default="artifact")
    ap.add_argument("--lanes", default="all", help="'all' or comma-separated lane indices")
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--threads", type=int, default=4, help="torch threads of the port's run")
    ap.add_argument("--out", default=None, help="write every lane's outcomes as JSON")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    with np.load(os.path.join(ROOT, "fixtures", DRAWS[args.draw])) as f:
        x0_all = f["online"].astype(np.float32)
    lanes = (np.arange(x0_all.shape[0]) if args.lanes == "all"
             else np.array([int(i) for i in args.lanes.split(",")]))
    out = {"draw": args.draw}
    for package in (("jax", "port") if args.package == "both" else (args.package,)):
        t0 = time.time()
        xf, ints = (fly_jax(x0_all[lanes], args.episodes) if package == "jax"
                    else fly_port(x0_all[lanes], args.episodes, args.threads))
        out[package] = summarise(package, lanes, xf, ints, time.time() - t0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
