"""Learning layer: GP pretraining and hyperparameter tuning."""

from .hyperparameter_tuner import HyperparameterConfig, tune_mle
from .pretrain import (
    collect_residuals_3dof,
    collect_residuals_6dof,
    explore_gp_3dof,
    gp_fns,
    pretrain_gp_3dof,
    pretrain_gp_6dof,
)

__all__ = ["HyperparameterConfig", "collect_residuals_3dof", "collect_residuals_6dof",
           "explore_gp_3dof", "gp_fns", "pretrain_gp_3dof", "pretrain_gp_6dof", "tune_mle"]
