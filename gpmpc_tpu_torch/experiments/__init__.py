"""Experiments layer (counterpart of ``gpmpc_tpu/experiments``, the same
public names): Monte-Carlo campaigns, baselines, dispersion, ablation,
statistics and exports, and figures."""

from .ablation import (
    ALL_COMPONENTS,
    AblationResult,
    AblationStudy,
    HyperparameterSweep,
    run_simple_ablation,
)
from .analysis import (
    PerformanceMetrics,
    ResultsExporter,
    StatisticalAnalyzer,
    compute_improvement,
    generate_summary_report,
    two_proportion_z_test,
    welch_t_test,
)
from .baselines import (
    create_baseline_controllers,
    make_gravity_turn_controller,
    make_lqr_controller,
    make_open_loop_controller,
    make_pid_controller,
)
from .dispersion import (
    DispersedDynamics,
    DispersedState,
    DispersionConfig,
    WindConfig,
    WindModel,
    dispersion_ellipse,
    make_dispersed_plant,
    run_dispersion_sweep,
    wind_velocity,
)
from .monte_carlo import (
    CONSTRAINT_VIOLATION,
    CRASH,
    DIVERGENCE,
    FUEL_EXHAUSTED,
    OUTCOME_NAMES,
    RUNNING,
    SUCCESS,
    TIMEOUT,
    LandingCriteria,
    SimulationConfig,
    campaign_statistics,
    classify_touchdown,
    compare_controllers,
    run_campaign,
    run_episode,
    sample_initial_conditions,
    summarize,
    wilson_interval,
)
from .visualization import (
    COLORBLIND_PALETTE,
    COLORS,
    GPVisualizer,
    MonteCarloVisualizer,
    TrajectoryVisualizer,
    create_ablation_figure,
    create_summary_figure,
    publication_style,
)

__all__ = [
    "ALL_COMPONENTS", "AblationResult", "AblationStudy", "COLORBLIND_PALETTE", "COLORS",
    "CONSTRAINT_VIOLATION", "CRASH", "DIVERGENCE", "DispersedDynamics", "DispersedState",
    "DispersionConfig", "FUEL_EXHAUSTED", "GPVisualizer", "HyperparameterSweep",
    "LandingCriteria", "MonteCarloVisualizer", "OUTCOME_NAMES", "PerformanceMetrics",
    "RUNNING", "ResultsExporter", "SUCCESS", "SimulationConfig", "StatisticalAnalyzer",
    "TIMEOUT", "TrajectoryVisualizer", "WindConfig", "WindModel", "campaign_statistics",
    "classify_touchdown", "compare_controllers", "compute_improvement",
    "create_ablation_figure", "create_baseline_controllers", "create_summary_figure",
    "dispersion_ellipse", "generate_summary_report", "make_dispersed_plant",
    "make_gravity_turn_controller", "make_lqr_controller", "make_open_loop_controller",
    "make_pid_controller", "publication_style", "run_campaign", "run_dispersion_sweep",
    "run_episode", "run_simple_ablation", "sample_initial_conditions", "summarize",
    "two_proportion_z_test", "welch_t_test", "wilson_interval", "wind_velocity",
]
