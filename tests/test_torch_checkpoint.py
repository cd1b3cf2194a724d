"""The port's checkpoints (``gpmpc_tpu_torch/utils/checkpoint.py``), the fleet-
LMPC campaign's resume from them (``main_path.fly_lmpc_fleet(...,
checkpoint=)``) and the kernel build cache
(``gpmpc_tpu_torch/utils/compile_cache.py``), against the JAX package on the
CPU where it has a twin."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.utils import CampaignCheckpointer as JaxCheckpointer
from gpmpc_tpu.utils.compile_cache import _prune_lru as jax_prune_lru
from gpmpc_tpu_torch.main_path import (fly_lmpc_fleet, lmpc_capacity, lmpc_fleet_path,
                                       lmpc_fleet_x0)
from gpmpc_tpu_torch.mpc import GPMPCState
from gpmpc_tpu_torch.ops.kernels import _build
from gpmpc_tpu_torch.terminal import SafeSet
from gpmpc_tpu_torch.utils import (CampaignCheckpointer, enable_compilation_cache,
                                   restore_pytree, save_pytree)
from gpmpc_tpu_torch.utils.compile_cache import _prune_lru

torch.set_num_threads(1)  # the suite's xdist workers share the cores


def test_checkpointer_roundtrip(tmp_path):
    """``tests/test_experiments.py``'s twin: two steps saved with keep=2, the
    newest restored, as the JAX checkpointer restores it."""
    ck = CampaignCheckpointer(str(tmp_path / "ck"), keep=2)
    state = {"a": torch.arange(5.0), "b": torch.ones(2, 2)}
    ck.save(1, state)
    ck.save(2, {k: v * 2 for k, v in state.items()})
    step, restored = ck.restore_latest(state)
    assert step == 2
    torch.testing.assert_close(restored["a"], torch.arange(5.0) * 2, rtol=0, atol=0)
    jck = JaxCheckpointer(str(tmp_path / "jck"), keep=2)
    jstate = {"a": jnp.arange(5.0), "b": jnp.ones((2, 2))}
    jck.save(1, jstate)
    jck.save(2, jax.tree.map(lambda x: x * 2, jstate))
    jstep, jrestored = jck.restore_latest(jstate)
    assert jstep == step
    for k in state:
        np.testing.assert_array_equal(restored[k].numpy(), np.asarray(jrestored[k]))


def test_checkpointer_keeps_the_newest(tmp_path):
    """``keep`` retention: of five steps the two newest stay on disk;
    ``latest_step`` is the newest, and an empty directory gives back the
    template."""
    ck = CampaignCheckpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    template = {"x": torch.zeros(3)}
    assert ck.restore_latest(template) == (None, template)
    for s in range(1, 6):
        ck.save(s, {"x": torch.full((3,), float(s))})
    assert sorted(os.listdir(tmp_path)) == ["step_00000004.npz", "step_00000005.npz"]
    step, tree = ck.restore_latest(template)
    assert step == 5 and tree["x"].tolist() == [5.0] * 3


def _safe_set():
    ss = SafeSet.create(64, 7, device="cpu")
    g = torch.Generator().manual_seed(0)
    return ss.add_trajectory(torch.randn(10, 7, generator=g), torch.randn(10, 3, generator=g),
                             torch.rand(10, generator=g))


def test_state_dataclasses_round_trip(tmp_path):
    """A nested tree of the port's state dataclasses (a ``SafeSet``, a
    ``GPMPCState`` with the warm-KKT carry and one without it, a list and a
    named tuple) comes back leaf for leaf; the static parts (None fields,
    the safe set's margin) come from the template, each leaf takes the
    template leaf's dtype."""
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)
    warm = GPMPCState(X_lin=r(2, 4, 7), U_lin=r(2, 3, 3), x_ref=r(2, 4, 7), rho=r(2), y_prev=r(2, 9),
                      kkt_inv=r(2, 5, 5), scal_D=r(2, 5), scal_E=r(2, 9), scal_c=r(2))
    cold = GPMPCState(X_lin=r(2, 4, 7), U_lin=r(2, 3, 3), x_ref=r(2, 4, 7), rho=r(2),
                      y_prev=r(2, 9))
    tree = {"set": _safe_set(), "states": [warm, cold], "steps": torch.tensor(7, dtype=torch.int32)}
    save_pytree(str(tmp_path / "t"), tree)
    zeros = lambda t: torch.zeros_like(t)
    template = {"set": SafeSet.create(64, 7, device="cpu"),
                "states": [GPMPCState(**{k: zeros(v) for k, v in vars(warm).items()}),
                           GPMPCState(**{k: zeros(v) for k, v in vars(cold).items()
                                         if v is not None})],
                "steps": torch.tensor(0, dtype=torch.int32)}
    back = restore_pytree(str(tmp_path / "t"), template)
    for k in ("states", "q_values", "traj_ids", "count", "written", "best_cost"):
        torch.testing.assert_close(getattr(back["set"], k), getattr(tree["set"], k), rtol=0, atol=0)
    assert back["set"].fuel_margin == tree["set"].fuel_margin
    for got, want in zip(back["states"], tree["states"]):
        for k, v in vars(want).items():
            if v is None:
                assert getattr(got, k) is None
            else:
                torch.testing.assert_close(getattr(got, k), v, rtol=0, atol=0)
    assert int(back["steps"]) == 7
    # the template's dtype wins
    t64 = {"set": template["set"], "states": [GPMPCState(**{
        k: (zeros(v).double() if v is not None else None) for k, v in vars(s).items()})
        for s in tree["states"]], "steps": template["steps"]}
    back64 = restore_pytree(str(tmp_path / "t"), t64)
    assert back64["states"][0].kkt_inv.dtype == torch.float64
    torch.testing.assert_close(back64["states"][0].kkt_inv, warm.kkt_inv.double())


def test_restore_refuses_a_template_of_another_shape(tmp_path):
    save_pytree(str(tmp_path / "t"), {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(str(tmp_path / "t"), {"a": torch.zeros(4), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(str(tmp_path / "t"), {"a": torch.zeros(3)})


def test_fly_lmpc_fleet_resumes_after_the_last_round(tmp_path, capsys):
    """``tests/test_scripts.py::test_fleet_lmpc_checkpoint_resume``'s twin at 4
    lanes: one round into a checkpoint directory, then a call for two rounds
    resumes after round 1 without flying it again and ends where two rounds
    flown at once end (the same capacity); ``meta.json`` pins the solver and
    the shaping of a path built for the directory, and a path that
    disagrees with it is refused."""
    lp = lmpc_fleet_path("3dof", "cpu")
    x0s = lmpc_fleet_x0(lp, torch.Generator().manual_seed(0), 4)
    cap = lmpc_capacity(lp, 4, 2, steps=120)
    full, ss_full = fly_lmpc_fleet(lp, x0s, rounds=2, steps=120, capacity=cap)
    ck = str(tmp_path / "ck")
    first, _ = fly_lmpc_fleet(lp, x0s, rounds=1, steps=120, capacity=cap, checkpoint=ck)
    assert first["resumed_after_round"] is None
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta == {"capacity": cap, "solver": "ipm", "touchdown_speed_weight": 250.0}
    lp_r = lmpc_fleet_path("3dof", "cpu", solver="admm", touchdown_weight=10.0, checkpoint=ck)
    assert (lp_r.config.solver, lp_r.config.touchdown_speed_weight) == ("ipm", 250.0)
    capsys.readouterr()
    res, ss = fly_lmpc_fleet(lp_r, x0s, rounds=2, steps=120, capacity=cap, checkpoint=ck)
    assert "resumed after round 1" in capsys.readouterr().out
    assert res["resumed_after_round"] == 1 and res["episodes_flown"] == 4
    for k in ("probe_lane_costs", "probe_plan_values", "touchdown_speed_by_round",
              "final_success_rate"):
        assert res[k] == full[k], k
    assert [r["round"] for r in res["per_round"]] == [1, 2]
    for k in ("states", "q_values", "traj_ids", "count", "written"):
        torch.testing.assert_close(getattr(ss, k), getattr(ss_full, k), rtol=0, atol=0)
    with pytest.raises(ValueError, match="lmpc_fleet_path"):
        fly_lmpc_fleet(lmpc_fleet_path("3dof", "cpu", solver="admm"), x0s, rounds=3,
                       steps=120, checkpoint=ck)


def _cache_files(d, sizes, atimes):
    os.makedirs(d, exist_ok=True)
    for i, (size, at) in enumerate(zip(sizes, atimes)):
        p = os.path.join(d, f"f{i}")
        with open(p, "wb") as f:
            f.write(b"x" * size)
        os.utime(p, (at, at))
    os.makedirs(os.path.join(d, "sub"), exist_ok=True)  # directories are left alone


def test_prune_lru_matches_jax(tmp_path):
    """``_prune_lru`` given the same files as the JAX one (sizes and access
    times) leaves the same survivors: oldest access first, down to the
    budget."""
    sizes = [300, 100, 250, 50, 400, 120]
    atimes = [1_000_000 + 10 * k for k in (5, 1, 4, 0, 3, 2)]
    for budget in (10_000, 900, 500, 0):
        ours, theirs = tmp_path / f"ours{budget}", tmp_path / f"theirs{budget}"
        _cache_files(ours, sizes, atimes)
        _cache_files(theirs, sizes, atimes)
        _prune_lru(str(ours), budget)
        jax_prune_lru(str(theirs), budget)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)), budget
    assert sorted(os.listdir(tmp_path / "ours900")) == ["f0", "f2", "sub"]


def test_enable_compilation_cache_moves_the_build_directory(tmp_path, monkeypatch):
    """The kernel libraries' directory moves to the given path (or
    ``GPMPC_JAX_CACHE``), is created and pruned to
    ``GPMPC_JAX_CACHE_MAX_GB``; after a library was loaded from another
    directory the call raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded", {})
    d = enable_compilation_cache(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache") and os.path.isdir(d)
    assert _build.BUILD_DIR == tmp_path / "cache"
    assert _build._target("admm_chunk")[1].parent == tmp_path / "cache"
    _cache_files(tmp_path / "env", [600, 600], [1_000_000, 1_000_010])
    monkeypatch.setenv("GPMPC_JAX_CACHE", str(tmp_path / "env"))
    monkeypatch.setenv("GPMPC_JAX_CACHE_MAX_GB", str(700 / 2**30))
    assert enable_compilation_cache() == str(tmp_path / "env")
    assert sorted(os.listdir(tmp_path / "env")) == ["f1", "sub"]
    monkeypatch.setitem(_build._loaded, "admm_chunk", object())
    with pytest.raises(RuntimeError, match="before any launch"):
        enable_compilation_cache(str(tmp_path / "other"))
