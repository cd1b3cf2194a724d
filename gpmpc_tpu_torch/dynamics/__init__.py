"""Dynamics layer: rocket models, integrators, linearization (counterpart
of ``gpmpc_tpu/dynamics``, the same public names)."""

from . import rocket3dof, rocket6dof
from .integrators import (
    STEP_FNS,
    euler_step,
    get_step_fn,
    heun_step,
    hermite_simpson_defect,
    integrate_sensitivity,
    integrate_trajectory,
    midpoint_step,
    quaternion_derivative,
    quaternion_euler_step,
    quaternion_exponential_step,
    quaternion_multiply,
    rk4_step,
    trapezoidal_defect,
)
from .linearize import (
    AffineModel,
    ad_jacobians,
    discretize_jacobians,
    numerical_jacobians,
    trajectory_jacobians,
    verify_jacobians,
)
from .rocket3dof import (
    Rocket3DoF,
    Rocket3DoFConfig,
    Rocket3DoFDynamics,
    Rocket3DoFParams,
    create_rocket_3dof,
)
from .rocket6dof import (
    Rocket6DoF,
    Rocket6DoFConfig,
    Rocket6DoFDynamics,
    Rocket6DoFParams,
    create_szmuk_rocket,
    dcm_from_quaternion,
    tilt_angle,
)

__all__ = [
    "AffineModel", "Rocket3DoF", "Rocket3DoFConfig", "Rocket3DoFDynamics", "Rocket3DoFParams",
    "Rocket6DoF", "Rocket6DoFConfig", "Rocket6DoFDynamics", "Rocket6DoFParams", "STEP_FNS",
    "ad_jacobians", "create_rocket_3dof", "create_szmuk_rocket", "dcm_from_quaternion",
    "discretize_jacobians", "euler_step", "get_step_fn", "heun_step", "hermite_simpson_defect",
    "integrate_sensitivity", "integrate_trajectory", "midpoint_step", "numerical_jacobians",
    "quaternion_derivative", "quaternion_euler_step", "quaternion_exponential_step",
    "quaternion_multiply", "rk4_step", "rocket3dof", "rocket6dof", "tilt_angle",
    "trajectory_jacobians", "trapezoidal_defect", "verify_jacobians",
]
