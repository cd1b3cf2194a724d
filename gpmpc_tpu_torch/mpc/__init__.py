"""Model-predictive control layer: the RTI cycle and the GP-MPC cycle."""

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

__all__ = ["GPMPCConfig", "GPMPCSolution", "GPMPCState", "RTIConfig", "RTISolution",
           "RTIState", "SimpleGPPredictor", "gp_mpc_init", "gp_mpc_solve",
           "make_gp_mpc_controller", "make_rti_controller",
           "rti_closed_loop", "rti_feedback", "rti_init", "rti_prepare", "rti_step",
           "simple_rti_step"]
