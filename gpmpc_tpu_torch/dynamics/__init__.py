"""Dynamics layer: the 3-DoF rocket, integrators, linearization."""

from . import rocket3dof
from .integrators import STEP_FNS, get_step_fn, rk4_step
from .linearize import trajectory_jacobians
from .rocket3dof import Rocket3DoFParams

__all__ = ["STEP_FNS", "Rocket3DoFParams", "get_step_fn", "rk4_step",
           "rocket3dof", "trajectory_jacobians"]
