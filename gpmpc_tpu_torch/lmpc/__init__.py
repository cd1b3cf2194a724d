"""Learning MPC on sampled safe sets (counterpart of ``gpmpc_tpu/lmpc``),
lanes first."""

from .lmpc import (
    LMPCConfig,
    LMPCSolution,
    LMPCState,
    SimpleLMPC,
    default_stage_cost,
    fly_episode,
    lmpc_config_6dof,
    lmpc_init,
    lmpc_plan_value,
    lmpc_solve,
    run_episode,
    run_fleet_iterations,
    run_iterations,
)

__all__ = [
    "LMPCConfig", "LMPCSolution", "LMPCState", "SimpleLMPC", "default_stage_cost",
    "lmpc_config_6dof", "lmpc_init", "fly_episode", "lmpc_plan_value", "lmpc_solve",
    "run_episode", "run_fleet_iterations", "run_iterations",
]
