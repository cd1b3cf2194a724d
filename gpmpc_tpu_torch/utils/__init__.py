"""Utilities (counterpart of ``gpmpc_tpu/utils``): configuration loading,
run logging, profiling, checkpoints and the kernel build cache."""

from .checkpoint import CampaignCheckpointer, restore_pytree, save_pytree
from .compile_cache import enable_compilation_cache
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

__all__ = [
    "enable_compilation_cache",
    "BenchmarkResults", "CampaignCheckpointer", "ControlLoopBenchmark", "LoopTiming",
    "MemoryProfiler", "Profiler", "RunLogger", "Timer", "apply_overrides",
    "benchmark_gp_prediction", "benchmark_mpc_solve", "build_gp_config", "build_mpc_config",
    "build_rocket_params", "build_safety_config", "get_logger", "load_experiment_config",
    "load_yaml", "profile_function", "restore_pytree", "save_pytree", "trace",
]
