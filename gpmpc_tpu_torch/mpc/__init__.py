"""Model-predictive control layer: constraints, costs, uncertainty
propagation, the RTI, nominal and GP-augmented controllers and the 6-DoF
RTI configuration (the JAX package's ``mpc`` surface)."""

from .constraints import (
    ConstraintParams,
    TightenedConstraints,
    check_all_constraints,
    check_constraints_3dof,
    constraint_jacobians,
    eval_angular_rate,
    eval_gimbal_angle,
    eval_glideslope,
    eval_thrust_magnitude,
    eval_tilt_angle,
    normal_quantile,
    tighten_bounds,
)
from .cost_functions import (
    CostWeights,
    LQRTerminalCost,
    compute_lqr_gain,
    fuel_optimal_stage_cost,
    quadratic_stage_cost,
    terminal_cost,
    tracking_stage_cost,
    trajectory_cost,
)
from .gp_mpc import (
    GPMPCConfig,
    GPMPCSolution,
    GPMPCState,
    SimpleGPPredictor,
    gp_mpc_init,
    gp_mpc_solve,
    make_gp_mpc_controller,
)
from .uncertainty_prop import (
    PropagatedUncertainty,
    TubeBasedRobustness,
    UncertaintyPropagator,
    box_tightening,
    gp_process_noise,
    linear_tightening,
    propagate_linear,
    propagate_monte_carlo,
    propagate_tube,
    propagate_unscented,
    sampled_tightening,
)
from .nominal import (
    MPCConfig,
    MPCSolution,
    NominalMPC,
    NominalMPC3DoF,
    make_nominal_mpc_controller,
)
from .rti6dof import (
    control_box_6dof,
    gimbal_cone_rows,
    glideslope_linearized,
    glideslope_rows,
    make_rti6dof_controller,
    project_control_6dof,
    rti_config_6dof,
    state_box_6dof,
)
from .rti import (
    RTIConfig,
    RTISolution,
    RTIState,
    make_rti_controller,
    rti_closed_loop,
    rti_feedback,
    rti_init,
    rti_prepare,
    rti_step,
    simple_rti_step,
)

__all__ = [
    "ConstraintParams", "GPMPCConfig", "GPMPCSolution", "GPMPCState", "PropagatedUncertainty",
    "SimpleGPPredictor", "TubeBasedRobustness", "UncertaintyPropagator", "box_tightening",
    "gp_mpc_init", "gp_mpc_solve", "gp_process_noise", "linear_tightening",
    "make_gp_mpc_controller", "propagate_linear", "propagate_monte_carlo", "propagate_tube",
    "propagate_unscented", "sampled_tightening", "CostWeights", "LQRTerminalCost", "MPCConfig",
    "MPCSolution", "NominalMPC", "NominalMPC3DoF", "RTIConfig", "RTISolution", "RTIState",
    "TightenedConstraints", "check_all_constraints", "check_constraints_3dof",
    "compute_lqr_gain", "constraint_jacobians", "eval_angular_rate", "eval_gimbal_angle",
    "eval_glideslope", "eval_thrust_magnitude", "eval_tilt_angle", "fuel_optimal_stage_cost",
    "normal_quantile", "control_box_6dof", "gimbal_cone_rows", "glideslope_linearized",
    "glideslope_rows", "make_nominal_mpc_controller", "make_rti6dof_controller",
    "project_control_6dof", "rti_config_6dof", "state_box_6dof", "make_rti_controller",
    "quadratic_stage_cost", "rti_closed_loop", "rti_feedback", "rti_prepare",
    "simple_rti_step", "rti_init", "rti_step", "terminal_cost", "tighten_bounds",
    "tracking_stage_cost", "trajectory_cost",
]
