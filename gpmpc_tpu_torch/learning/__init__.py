"""Learning layer: GP pretraining, hyperparameter tuning and the online
learning GP-MPC controller."""

from .hyperparameter_tuner import HyperparameterConfig, tune_mle
from .online_gp_mpc import (
    OnlineGPMPCConfig,
    OnlineGPMPCState,
    carry_gp_between_episodes,
    make_online_gp_mpc_controller,
    online_controller_info,
)
from .pretrain import (
    collect_residuals_3dof,
    collect_residuals_6dof,
    explore_gp_3dof,
    gp_fns,
    pretrain_gp_3dof,
    pretrain_gp_6dof,
)

__all__ = ["HyperparameterConfig", "OnlineGPMPCConfig", "OnlineGPMPCState",
           "carry_gp_between_episodes", "collect_residuals_3dof", "collect_residuals_6dof",
           "explore_gp_3dof", "gp_fns", "make_online_gp_mpc_controller",
           "online_controller_info", "pretrain_gp_3dof", "pretrain_gp_6dof", "tune_mle"]
