"""The port's ``utils`` against the JAX package's: the experiment config
loaded from ``config/`` field by field, overrides, the YAML reader against
``yaml.safe_load``, the JSONL run log, and the profiler's statistics on
fixed inputs."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gpmpc_tpu import utils as JU
from gpmpc_tpu_torch import utils as TU
from gpmpc_tpu_torch.utils.config_loader import parse_yaml

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config")
YAMLS = sorted(f for f in os.listdir(CONFIG) if f.endswith(".yaml"))


def _same(a, b, where=""):
    """Field-by-field equality of a port object and its JAX twin: tensors
    against arrays exactly, dataclasses by the fields both have (the port's
    ``ADMMConfig`` leaves out the fields that only tune solver features it
    lacks, ``ops/qp/admm.py``)."""
    if isinstance(a, torch.Tensor):
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b), err_msg=where)
    elif dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            if f.name == "device" or not hasattr(a, f.name):
                continue
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif hasattr(b, "shape") and not isinstance(b, (int, float)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    else:
        assert a == b, (where, a, b)


KEYS = ["rocket_params", "mpc_config", "gp_config", "online_config", "training_config",
        "safety_config", "tube_config", "backup_kind", "raw"]


@pytest.mark.parametrize("key", KEYS)
def test_load_experiment_config_matches_jax(key):
    t = TU.load_experiment_config(CONFIG, device="cpu")
    j = JU.load_experiment_config(CONFIG)
    _same(t[key], j[key], key)


@pytest.mark.parametrize("key", ["rocket_params", "mpc_config"])
def test_overrides_round_trip(key):
    ov = {"mpc.use_gp": True, "mpc.N": 20, "mpc.rti.scp_iterations": 2,
          "mpc.x_bound_mask": [False] * 7, "gp.uncertainty.beta_method": "fixed",
          "rocket.model": "6dof", "rocket.T_min": 1.0}
    t = TU.load_experiment_config(CONFIG, overrides=ov, device="cpu")
    j = JU.load_experiment_config(CONFIG, overrides=ov)
    _same(t[key], j[key], key)
    if key == "mpc_config":
        assert type(t[key]).__name__ == "GPMPCConfig" and t[key].base.N == 20
        assert t[key].beta_method == "fixed" and t[key].base.x_bound_mask == (False,) * 7
    raw = TU.apply_overrides({"a": {"b": 1}}, {"a.c.d": 2, "e": 3})
    assert raw == JU.apply_overrides({"a": {"b": 1}}, {"a.c.d": 2, "e": 3})


@pytest.mark.parametrize("fname", YAMLS)
def test_yaml_reader_matches_safe_load(fname):
    path = os.path.join(CONFIG, fname)
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert TU.load_yaml(path) == ref


SNIPPETS = [
    "a: 1\nb: -2\nc: 0.5\nd: 1.0e-4\ne: 1e-4\nf: .5\n",
    "on: yes\noff: no\nt: true\nF: False\nn: null\nt2: ~\n",
    "s: 'quoted # not a comment'  # a comment\nd: \"x: y\"\nplain: se_ard\n",
    "top:\n  mid:\n    leaf: [1, 2.0, null, true, word]\n  empty:\nlast: []\n",
    "# only a comment\n\nk: v # trailing\n",
    "inf: .inf\nninf: -.inf\nnum_: 1_000\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_reader_matches_safe_load_on_snippets(text):
    out, ref = parse_yaml(text), yaml.safe_load(text)
    assert out == ref
    assert [type(v) for v in out.values()] == [type(v) for v in ref.values()]


@pytest.mark.parametrize("text", ["- a\n- b\n", "a: {b: 1}\n", "a: [[1]]\n", "a: &x 1\n",
                                  "a:\n    b: 1\n  c: 2\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_run_logger_events_have_the_jax_fields(tmp_path, capsys):
    class Odd:
        def __str__(self):
            return "odd"

    logs = {}
    for name, mod in (("port", TU), ("jax", JU)):
        path = tmp_path / f"{name}.jsonl"
        log = mod.RunLogger(str(path))
        log.log("start", n_runs=8, devices=["cpu"])
        log.log("campaign", controller="gp_mpc", success_rate=0.5, obj=Odd())
        log.close()
        logs[name] = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(logs["port"]) == len(logs["jax"]) == 2
    for a, b in zip(logs["port"], logs["jax"]):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k != "t"} == {k: v for k, v in b.items() if k != "t"}
        assert isinstance(a["t"], float)
    TU.RunLogger().log("stdout", x=1)
    assert json.loads(capsys.readouterr().out)["event"] == "stdout"
    assert TU.get_logger().name == "gpmpc_tpu_torch"


MS = [3.0, 1.5, 9.25, 4.0, 2.5, 7.75, 5.0, 6.5, 0.5, 8.0]


def test_profiler_statistics_match_jax():
    profs = (TU.Profiler(), JU.Profiler())
    for p in profs:
        for i, ms in enumerate(MS):
            p.add("solve" if i % 3 else "gp", ms)
    for sec in ("solve", "gp"):
        assert profs[0].stats(sec) == profs[1].stats(sec)
    assert profs[0].report() == profs[1].report()


def test_benchmark_results_percentiles_match_jax():
    res = (TU.BenchmarkResults(warmup=2), JU.BenchmarkResults(warmup=2))
    for i, ms in enumerate(MS):
        for r, mod in zip(res, (TU, JU)):
            r.add(mod.LoopTiming(gp_ms=ms, mpc_ms=2 * ms, safety_ms=0.5, dynamics_ms=0.25,
                                 overhead_ms=i * 0.1))
    assert res[0].summary() == res[1].summary()
    for p in (50, 90, 95, 99):
        assert res[0].get_percentile(p) == res[1].get_percentile(p)
    lt = TU.LoopTiming(gp_ms=4.0, mpc_ms=10.0)
    assert lt.achieves_50hz and not lt.achieves_100hz and lt.total_ms == 14.0


def test_control_loop_benchmark_and_timers():
    bench = TU.ControlLoopBenchmark(warmup=1)
    x = torch.ones(4)
    for _ in range(3):
        bench.start_step()
        with bench.phase("mpc", result=x * 2):
            pass
        with bench.phase("gp", result={"a": (x, [x])}):
            pass
        bench.finish_step()
    s = bench.results.summary()
    assert s["n"] == 2 and s["meets_50hz"] and s["mean_ms"] >= 0.0
    with TU.Timer("t", result=x) as t:
        pass
    assert t.elapsed_ms >= 0.0
    prof = TU.Profiler()
    f = TU.profile_function(prof, "double")(lambda v: v * 2)
    assert torch.equal(f(x), 2 * x) and prof.stats("double")["n"] == 1
    with prof.section("s", result=x):
        pass
    assert "double" in prof.report()
    r = TU.benchmark_mpc_solve(lambda a: a + 1, (x,), n_repeats=3)
    assert set(r) == {"mean_ms", "p95_ms", "meets_50hz", "meets_100hz"}
    assert set(TU.benchmark_gp_prediction(lambda a: a, x, 3)) == {"mean_ms", "p95_ms", "meets_5ms"}


def test_memory_profiler_counts_tensor_bytes_as_jax_counts_array_bytes():
    shapes = {"P": ((64, 60, 60), np.float32), "idx": ((64,), np.int32),
              "mask": ((64, 200), np.bool_), "x": ((3, 7), np.float64)}
    t_tree = {k: (torch.zeros(s, dtype=getattr(torch, np.dtype(d).name if d is not np.bool_
                                                else "bool")),) for k, (s, d) in shapes.items()}
    j_tree = {k: (np.zeros(s, d),) for k, (s, d) in shapes.items()}
    j_tree["x"] = (jnp.zeros((3, 7), jnp.float32),)
    t_tree["x"] = (torch.zeros(3, 7),)
    assert TU.MemoryProfiler.nbytes(t_tree) == JU.MemoryProfiler.nbytes(j_tree)
    assert TU.MemoryProfiler.nbytes(t_tree) == 64 * 3600 * 4 + 64 * 4 + 64 * 200 + 84
    assert TU.MemoryProfiler.report({"tree": t_tree}) == JU.MemoryProfiler.report({"tree": j_tree})


def test_trace_writes_a_chrome_trace(tmp_path):
    with TU.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
