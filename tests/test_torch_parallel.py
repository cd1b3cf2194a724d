"""The port's lane sharding (``gpmpc_tpu_torch/parallel``) against the JAX
package on the CPU: the twins of ``tests/test_parallel.py`` and
``tests/test_multiprocess.py``.

The port runs for real on gloo process groups of 8 and of 2 ranks, one
process each (``tests/_torch_parallel_worker.py``, spawned once per module
by the fixtures below); the JAX package runs on the 8-device virtual CPU
mesh of ``tests/conftest.py``. Both get the same initial states, drawn by
the JAX package's sampler and handed to the port as NumPy arrays, and the
same GP, fitted by the JAX package and carried across by
``gpmpc_tpu_torch.convert``."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.experiments import SimulationConfig as JaxSim
from gpmpc_tpu.experiments import campaign_statistics as jax_stats
from gpmpc_tpu.experiments import run_campaign as jax_run_campaign
from gpmpc_tpu.experiments import sample_initial_conditions as jax_sample
from gpmpc_tpu.parallel import gather_safe_sets as jax_gather
from gpmpc_tpu.parallel import hosts_chips_mesh as jax_hosts_chips_mesh
from gpmpc_tpu.parallel import run_sharded_campaign as jax_run_sharded
from gpmpc_tpu.parallel import scenario_mesh as jax_scenario_mesh
from gpmpc_tpu.parallel import shard_over_mesh as jax_shard_over_mesh
from gpmpc_tpu.parallel import sharded_campaign_statistics as jax_sharded_stats
from gpmpc_tpu.terminal import SafeSet as JaxSafeSet
from gpmpc_tpu_torch.parallel import (broadcast_from_host0, gather_safe_sets,
                                      gather_safe_sets_global, initialize_distributed,
                                      per_host_keys)
from gpmpc_tpu_torch.terminal import SafeSet

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_parallel import descent_controller as jax_descent  # noqa: E402
from test_torch_gp import jax_gp_to_numpy  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
FIELDS = ("outcome", "fuel_used", "landing_speed", "landing_error", "steps")
SCALARS = ("fuel_used_mean", "fuel_used_std", "landing_speed_mean", "landing_error_mean",
           "steps_mean")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(mode: str, world: int, out_dir: Path) -> list:
    """Run ``world`` ranks of the worker on one gloo group; returns each
    rank's output (``rank<r>.pt``)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), mode, str(r), str(world), str(port),
                               str(out_dir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"TORCH_MP_OK {r}" in out, f"rank {r}:\n{out}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _gp_numpy():
    """``tests/test_parallel.py``'s tiny fitted GP (48 exploration steps, 12
    inducing points), fitted by the JAX package."""
    from gpmpc_tpu.gp import ResidualCollector, Simple3DoFGP, StructuredGPConfig

    p = JaxParams()
    p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    F = lambda x, u: jr.step(p, x, u, 0.1)
    F_true = lambda x, u: jr.step(p_true, x, u, 0.1)

    def explore(x, k):
        u = jr.clamp_thrust(p, jr.hover_thrust(p, x) + 0.3 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), k), (3,)))
        return F_true(x, u), (x, u, F_true(x, u))

    _, (Xd, Ud, Xnd) = jax.lax.scan(
        explore, jnp.array([2.0, 15.0, 0.5, -0.5, -2.0, 0.1, 0.1]), jnp.arange(48))
    res = ResidualCollector(dt=0.1).collect_batch(F, Xd, Ud, Xnd)
    gp = Simple3DoFGP.create(StructuredGPConfig(max_data_points=48, n_inducing=12))
    gp = gp.add_data_batch(Xd, Ud, res).fit(jax.random.PRNGKey(1))
    d = jax_gp_to_numpy(gp)
    d["config"] = {"max_data_points": 48, "n_inducing": 12}
    return d


def _jax_campaign(x0s, max_steps):
    p = JaxParams()
    sim = JaxSim(max_steps=max_steps, altitude_mean=15.0, altitude_std=1.0)
    cinit, cstep = jax_descent(p)
    plant = lambda x, u: jr.step(p, x, u, sim.dt)
    return cinit, cstep, plant, sim


@pytest.fixture(scope="module")
def jax_side(devices8):
    """The inputs (JAX draws) and the JAX package's campaigns: the 200-step
    descent campaign sharded on the 8-device mesh and unsharded, and the
    180-step one's statistics by ``shard_map`` on a 2 x 4 mesh."""
    sim = JaxSim(max_steps=200, altitude_mean=15.0, altitude_std=1.0)
    x0s = jax_sample(jax.random.PRNGKey(0), sim, 32)
    cinit, cstep, plant, sim = _jax_campaign(x0s, 200)
    sharded = jax_run_sharded(jax_scenario_mesh(devices8), cinit, cstep, plant, x0s, sim)
    unsharded = jax.jit(lambda xs: jax_run_campaign(cinit, cstep, plant, xs, sim))(x0s)
    cinit, cstep, plant, sim180 = _jax_campaign(x0s, 180)
    res180 = jax.jit(lambda xs: jax_run_campaign(cinit, cstep, plant, xs, sim180))(x0s)
    mesh24 = jax.sharding.Mesh(np.asarray(devices8).reshape(2, 4), ("hosts", "chips"))
    with mesh24:
        stats24 = jax.device_get(jax_sharded_stats(mesh24, jax_shard_over_mesh(mesh24, res180)))
    x0s_gp = jax_sample(jax.random.PRNGKey(5), JaxSim(max_steps=40, altitude_mean=12.0,
                                                      altitude_std=1.0), 16)
    return dict(x0s=np.asarray(x0s), x0s_gp=np.asarray(x0s_gp), gp=_gp_numpy(),
                stats=jax.device_get(sharded["stats"]), results=jax.device_get(unsharded),
                stats24=stats24, ref24=jax.device_get(jax_stats(res180)))


@pytest.fixture(scope="module")
def ranks8(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks8")
    torch.save({k: jax_side[k] for k in ("x0s", "x0s_gp", "gp")}, d / "inputs.pt")
    return _spawn("world", 8, d)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn("pair", 2, tmp_path_factory.mktemp("ranks2"))


def test_sharded_campaign_matches_jax(ranks8, jax_side):
    """``TestShardedCampaign.test_matches_unsharded``'s twin: the port's
    8-rank campaign statistics against the JAX package's 8-device ones
    (success within 1e-6, fuel mean rtol 1e-4), the same on every rank."""
    ref = jax_side["stats"]
    for out in ranks8:
        st = out["descent"]["stats"]
        assert st == ranks8[0]["descent"]["stats"]
        assert st["success_rate"] == pytest.approx(float(ref["success_rate"]), abs=1e-6)
        np.testing.assert_allclose(st["fuel_used_mean"], float(ref["fuel_used_mean"]), rtol=1e-4)
        assert st["n_runs"] == 32


def test_each_rank_flies_its_lanes_as_unsharded(ranks8):
    """Every rank flies its contiguous block of 4 lanes, in rank order, and
    each lane's result is the unsharded campaign's bit for bit (the descent
    law is elementwise: nothing reorders)."""
    ref = ranks8[0]["descent_unsharded"]
    for r, out in enumerate(ranks8):
        assert out["descent"]["lanes"] == (4 * r, 4 * r + 4)
        for k, v in out["descent"]["results"].items():
            torch.testing.assert_close(v, ref[k][4 * r:4 * r + 4], rtol=0, atol=0, msg=k)


def test_sharded_lanes_match_jax_lane_for_lane(ranks8, jax_side):
    """The port's lanes against the JAX package's unsharded campaign: the
    same outcomes and step counts, fuel and touchdown within f32 noise of
    200 steps of the dynamics."""
    got = {k: torch.cat([o["descent"]["results"][k] for o in ranks8]).numpy()
           for k in FIELDS + ("x_final",)}
    ref = jax_side["results"]
    np.testing.assert_array_equal(got["outcome"], np.asarray(ref["outcome"]))
    np.testing.assert_array_equal(got["steps"], np.asarray(ref["steps"]))
    for k in ("fuel_used", "landing_speed", "landing_error"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_batch_must_divide_mesh(ranks8, devices8):
    """12 lanes on 8 ranks raise ``ValueError`` on every rank, as on the JAX
    package's 8-device mesh."""
    for out in ranks8:
        assert out["divide_error"] is not None and "must divide" in out["divide_error"]
    cinit, cstep, plant, _ = _jax_campaign(None, 10)
    with pytest.raises(ValueError):
        jax_run_sharded(jax_scenario_mesh(devices8), cinit, cstep, plant, jnp.zeros((12, 7)),
                        JaxSim(max_steps=10))


def test_scenario_placements(ranks8, jax_side):
    """``shard_scenarios`` keeps each rank's 4 lanes as a ``Shard(0)``
    DTensor whose full tensor is the global one; ``replicate`` holds it
    whole everywhere; the mesh is 1-D over the 8 ranks."""
    for out in ranks8:
        assert out["mesh"] == (("scenarios",), (8,))
        d = out["dtensor"]
        assert d["local"] == (4, 7) and d["placements"] == [("Shard", 0)]
        np.testing.assert_array_equal(d["full"].numpy(), jax_side["x0s"])
        np.testing.assert_array_equal(d["replicated"].numpy(), jax_side["x0s"])


def test_hosts_chips_mesh_shape(ranks8, devices8):
    """``TestExplicitCollectives.test_hosts_chips_mesh_shape``'s twin: one
    host of 8 without ``LOCAL_WORLD_SIZE``, 2 x 4 with 4; the scenario spec
    shards the leading axis over both axes."""
    jm = jax_hosts_chips_mesh(devices8)
    assert jm.axis_names == ("hosts", "chips") and jm.devices.shape == (1, 8)
    for out in ranks8:
        assert out["hosts_chips"] == (1, 8)
        assert out["hosts_chips_24"] == (("hosts", "chips"), (2, 4))
        assert out["stats24_placements"] == [("Shard", 0), ("Shard", 0)]


def test_shard_map_statistics_match_reference(ranks8, jax_side):
    """``TestExplicitCollectives.test_shard_map_statistics_match_reference``'s
    twin on a 2 x 4 mesh: the all-reduced statistics against the JAX
    package's shard_map ones and its ``campaign_statistics`` (counts equal,
    the rest rtol 1e-4, atol 1e-6), and against the port's own
    ``campaign_statistics`` of the same lanes (counts equal, the rest
    within 1e-6)."""
    for ref in (jax_side["stats24"], jax_side["ref24"]):
        for out in ranks8:
            st = out["stats24"]
            assert st["success_rate"] == pytest.approx(float(ref["success_rate"]), abs=1e-6)
            for k in SCALARS:
                np.testing.assert_allclose(st[k], float(ref[k]), rtol=1e-4, atol=1e-6, err_msg=k)
            for name, cnt in ref["outcome_counts"].items():
                assert st["outcome_counts"][name] == int(cnt)
    for out in ranks8:
        st, own = out["stats24"], out["stats24_local"]
        assert st["outcome_counts"] == own["outcome_counts"] and st["n_runs"] == own["n_runs"]
        for k in SCALARS + ("success_rate",):
            assert st[k] == pytest.approx(own[k], abs=1e-6), k
        np.testing.assert_allclose(st["success_ci"], own["success_ci"], atol=1e-6)


def test_gp_mpc_sharded_matches_unsharded(ranks8):
    """``TestShardedRealControllers.test_gp_mpc_sharded_matches_unsharded``'s
    twin: the GP-MPC campaign (N = 10, two SCP iterations, tightening, the
    JAX-fitted GP), 16 lanes over 8 ranks against the same 16 lanes in one
    process: outcomes equal, touchdown states within the JAX test's 1e-2."""
    ref = ranks8[0]["gpmpc_unsharded"]
    for r, out in enumerate(ranks8):
        assert out["gpmpc"]["lanes"] == (2 * r, 2 * r + 2)
        res = out["gpmpc"]["results"]
        torch.testing.assert_close(res["outcome"], ref["outcome"][2 * r:2 * r + 2],
                                   rtol=0, atol=0)
        torch.testing.assert_close(res["x_final"], ref["x_final"][2 * r:2 * r + 2],
                                   rtol=0, atol=1e-2)


@pytest.mark.parametrize("world", [2, 8])
def test_multiprocess_gather_and_broadcast(world, request):
    """``tests/test_multiprocess.py``'s twin on 2 and on 8 ranks: every
    rank's global safe-set gather equals the merge of every rank's set
    (each rank rebuilds them all from seeds), and the broadcast hands every
    rank rank 0's tree (tensors, an int, a bool mask and a ``SafeSet``)."""
    ranks = request.getfixturevalue(f"ranks{world}")
    for out in ranks:
        got, exp = out["gather"], out["gather_expected"]
        for k in ("states", "q_values", "controls", "fuel_required"):
            torch.testing.assert_close(got[k], exp[k], rtol=1e-6, atol=1e-7, msg=k)
        for k in ("traj_ids", "count", "n_trajectories"):
            torch.testing.assert_close(got[k], exp[k], rtol=0, atol=0, msg=k)
        assert int(got["count"]) == min(16 * world, 32)
        b = out["broadcast"]
        torch.testing.assert_close(b["a"], torch.arange(4.0), rtol=0, atol=0)
        assert b["b"].dtype == torch.int32 and int(b["b"]) == 0
        assert b["flag"].tolist() == [True, False]
        torch.testing.assert_close(b["set_states"], b["set_expected"], rtol=0, atol=0)


def _jax_set(s):
    ss = JaxSafeSet.create(64, 7)
    X = jnp.tile(jnp.arange(7.0), (10, 1)) + s
    return ss.add_trajectory(X, jnp.zeros((10, 3)), jnp.linspace(1.0 + s, 0.1, 10))


def test_gather_safe_sets_matches_jax():
    """``TestSafeSetGather``'s twin: four shards merged to capacity 32 keep
    the lowest-Q rows of all of them, field for field as the JAX merge."""
    sets = []
    for s in range(4):
        X = torch.arange(7.0).repeat(10, 1) + s
        sets.append(SafeSet.create(64, 7, device="cpu").add_trajectory(
            X, torch.zeros(10, 3), torch.linspace(1.0 + s, 0.1, 10)))
    merged = gather_safe_sets(sets, capacity=32)
    ref = jax_gather([_jax_set(s) for s in range(4)], capacity=32)
    assert int(merged.count) == int(ref.count) == 32
    assert float(merged.best_cost) == min(float(s.best_cost) for s in sets)
    for k in ("states", "q_values", "controls", "fuel_required", "traj_ids"):
        np.testing.assert_allclose(getattr(merged, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_per_host_keys_distinct_and_deterministic():
    """``TestPRNG``'s twin: the same base gives the same generators, the
    hosts' draws differ (the draws are the port's own, not ``fold_in``'s)."""
    draw = lambda gs: [torch.rand(4, generator=g).tolist() for g in gs]
    a = draw(per_host_keys(7, 4, device="cpu"))
    b = draw(per_host_keys(torch.Generator().manual_seed(7), 4, device="cpu"))
    assert a == b
    assert len({tuple(d) for d in a}) == 4
    assert draw(per_host_keys(8, 4, device="cpu")) != a


def test_single_process_distributed_surface(monkeypatch):
    """``TestExplicitCollectives.test_single_process_distributed_surface``'s
    twin: without a rendezvous ``initialize_distributed`` starts nothing and
    returns False; the broadcast is the identity, the global gather the
    identity merge."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    tree = {"a": torch.arange(3.0)}
    assert broadcast_from_host0(tree) is tree
    ss = SafeSet.create(32, 7, device="cpu").add_trajectory(
        torch.arange(7.0).repeat(6, 1), torch.zeros(6, 3), torch.linspace(1.0, 0.1, 6))
    assert int(gather_safe_sets_global(ss, capacity=32).count) == 6
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("localhost:1", device="cpu")
