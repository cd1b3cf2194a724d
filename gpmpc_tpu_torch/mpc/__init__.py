"""Model-predictive control layer of the 3-DoF slice: the GP-MPC cycle."""

from .gp_mpc import GPMPCConfig, GPMPCSolution, GPMPCState, gp_mpc_init, gp_mpc_solve
from .rti import RTIConfig

__all__ = ["GPMPCConfig", "GPMPCSolution", "GPMPCState", "RTIConfig",
           "gp_mpc_init", "gp_mpc_solve"]
