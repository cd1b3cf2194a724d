"""Reference-trajectory layer (counterpart of ``gpmpc_tpu/reference``, the
same public names): analytic descent profiles, SCVX and the trajectory
library."""

from .profiles import cubic_descent_reference, pad_reference
from .scvx import SCVXConfig, SCVXSolution, SCVXSolver, SimpleSCVX, scvx_free_time, scvx_solve
from .trajectory_library import (
    Trajectory,
    TrajectoryLibrary,
    TrajectoryMetadata,
    generate_trajectory_library,
)

__all__ = [
    "SCVXConfig", "SCVXSolution", "SCVXSolver", "SimpleSCVX", "Trajectory", "TrajectoryLibrary",
    "TrajectoryMetadata", "cubic_descent_reference", "generate_trajectory_library",
    "pad_reference", "scvx_free_time", "scvx_solve",
]
