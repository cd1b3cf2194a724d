"""Learning layer: GP pretraining, hyperparameter tuning, data management
and novelty selection, the online learning GP-MPC controller and fleet
learning."""

from .batched_learner import BatchedLearningConfig, run_batched_learning
from .data_manager import DataManager, StreamingDataCollector, TransitionStore, compute_residual
from .hyperparameter_tuner import (
    AdaptiveHyperparameterScheduler,
    HyperparameterConfig,
    HyperparameterTuner,
    tune_cv_random,
    tune_map,
    tune_mle,
)
from .novelty_selector import (
    ActiveDataSelector,
    NoveltyConfig,
    NoveltySelector,
    distance_novelty,
    novelty_scores,
    residual_novelty,
    select_diverse,
    select_threshold_mask,
    select_top_k,
    variance_novelty,
)
from .online_gp_mpc import (
    OnlineGPMPCConfig,
    OnlineGPMPCState,
    carry_gp_between_episodes,
    make_online_gp_mpc_controller,
    online_controller_info,
)
from .online_learner import (
    IterativeLearningRunner,
    LearningStatistics,
    OnlineLearner,
    OnlineLearningConfig,
)
from .pretrain import (
    collect_residuals_3dof,
    collect_residuals_6dof,
    explore_gp_3dof,
    gp_fns,
    pretrain_gp_3dof,
    pretrain_gp_6dof,
)

__all__ = [
    "ActiveDataSelector", "AdaptiveHyperparameterScheduler", "BatchedLearningConfig",
    "DataManager", "HyperparameterConfig", "HyperparameterTuner", "IterativeLearningRunner",
    "LearningStatistics", "NoveltyConfig", "OnlineLearner", "OnlineLearningConfig",
    "NoveltySelector", "OnlineGPMPCConfig", "OnlineGPMPCState", "StreamingDataCollector",
    "TransitionStore", "carry_gp_between_episodes", "collect_residuals_3dof",
    "collect_residuals_6dof", "compute_residual", "distance_novelty", "explore_gp_3dof",
    "gp_fns", "make_online_gp_mpc_controller", "novelty_scores", "online_controller_info",
    "pretrain_gp_3dof", "pretrain_gp_6dof", "residual_novelty", "run_batched_learning",
    "select_diverse", "select_threshold_mask", "select_top_k", "tune_cv_random", "tune_map",
    "tune_mle", "variance_novelty",
]
