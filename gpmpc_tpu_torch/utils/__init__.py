"""Utilities (counterpart of ``gpmpc_tpu/utils``): configuration loading,
run logging and profiling."""

from .config_loader import (
    apply_overrides,
    build_gp_config,
    build_mpc_config,
    build_rocket_params,
    build_safety_config,
    load_experiment_config,
    load_yaml,
)
from .logging_utils import RunLogger, get_logger
from .profiler import (
    BenchmarkResults,
    ControlLoopBenchmark,
    LoopTiming,
    MemoryProfiler,
    Profiler,
    Timer,
    benchmark_gp_prediction,
    benchmark_mpc_solve,
    profile_function,
    trace,
)

# the JAX package's names, less the checkpoint and the compilation cache
__all__ = [
    "BenchmarkResults", "ControlLoopBenchmark", "LoopTiming", "MemoryProfiler", "Profiler",
    "RunLogger", "Timer", "apply_overrides", "benchmark_gp_prediction", "benchmark_mpc_solve",
    "build_gp_config", "build_mpc_config", "build_rocket_params", "build_safety_config",
    "get_logger", "load_experiment_config", "load_yaml", "profile_function", "trace",
]
