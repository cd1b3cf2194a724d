"""Model-predictive control layer: the RTI cycle, the GP-MPC cycle and the
6-DoF RTI configuration."""

from .cost_functions import CostWeights
from .gp_mpc import (
    GPMPCConfig,
    GPMPCSolution,
    GPMPCState,
    SimpleGPPredictor,
    gp_mpc_init,
    gp_mpc_solve,
    make_gp_mpc_controller,
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

__all__ = ["CostWeights", "GPMPCConfig", "GPMPCSolution", "GPMPCState", "RTIConfig", "RTISolution",
           "RTIState", "SimpleGPPredictor", "gp_mpc_init", "gp_mpc_solve",
           "make_gp_mpc_controller", "make_rti_controller",
           "rti_closed_loop", "rti_feedback", "rti_init", "rti_prepare", "rti_step",
           "simple_rti_step", "control_box_6dof", "gimbal_cone_rows", "glideslope_linearized",
           "glideslope_rows", "make_rti6dof_controller", "project_control_6dof",
           "rti_config_6dof", "state_box_6dof"]
