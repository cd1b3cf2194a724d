"""Safety layer: the predictive filter, backup controllers, invariant sets
and tubes (the JAX package's ``safety`` surface)."""

from .backup_controller import (
    EmergencyBrakingController,
    LQRBackupController,
    PDBackupController,
    create_backup_controller,
    hover_backup_3dof,
)
from .invariant_sets import (
    DescentFunnelSet,
    EllipsoidalInvariantSet,
    PolytopeInvariantSet,
    TubeController,
    compute_from_lqr,
    compute_lmi_invariant_set,
    compute_maximal_alpha,
)
from .safety_filter import (
    SafetyFilterConfig,
    SafetyFilterResult,
    SimpleSafetyFilter,
    check_safety,
    filter_control,
    filter_gradient,
    filtered_controller_info,
    make_filtered_controller,
    simulate_filtered,
)
from .tube_mpc import (
    RobustTubeMPC,
    TubeConstraintTightener,
    TubeMPCConfig,
    TubePropagator,
)

__all__ = [
    "DescentFunnelSet",
    "EllipsoidalInvariantSet",
    "EmergencyBrakingController",
    "LQRBackupController",
    "PDBackupController",
    "PolytopeInvariantSet",
    "RobustTubeMPC",
    "SafetyFilterConfig",
    "SafetyFilterResult",
    "SimpleSafetyFilter",
    "TubeConstraintTightener",
    "TubeController",
    "TubeMPCConfig",
    "TubePropagator",
    "check_safety",
    "compute_from_lqr",
    "compute_lmi_invariant_set",
    "compute_maximal_alpha",
    "create_backup_controller",
    "filter_control",
    "filter_gradient",
    "filtered_controller_info",
    "hover_backup_3dof",
    "make_filtered_controller",
    "simulate_filtered",
]
