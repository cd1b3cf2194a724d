"""Dynamics layer: the 3-DoF and 6-DoF rockets, integrators, linearization."""

from . import rocket3dof, rocket6dof
from .integrators import STEP_FNS, get_step_fn, rk4_step
from .linearize import trajectory_jacobians
from .rocket3dof import Rocket3DoFParams
from .rocket6dof import Rocket6DoFParams

__all__ = ["STEP_FNS", "Rocket3DoFParams", "Rocket6DoFParams", "get_step_fn", "rk4_step",
           "rocket3dof", "rocket6dof", "trajectory_jacobians"]
