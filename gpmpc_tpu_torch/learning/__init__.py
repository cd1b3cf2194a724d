"""Learning layer of the 3-DoF slice: GP pretraining."""

from .pretrain import explore_gp_3dof

__all__ = ["explore_gp_3dof"]
