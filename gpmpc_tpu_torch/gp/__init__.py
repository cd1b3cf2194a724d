"""Gaussian-process layer of the 3-DoF slice."""

from .exact_gp import GPPrediction
from .features import AtmosphereModel, Simple3DoFFeatureExtractor, simple_3dof_features
from .kernels import SquaredExponentialARD, create_kernel
from .online_update import ResidualCollector
from .sparse_gp import (
    MultiOutputSparseGPState,
    fit_sparse_multi,
    init_inducing_points,
    predict_sparse_multi,
    refit_sparse_multi,
    sparse_lml,
)
from .structured_gp import RingBuffer, Simple3DoFGP, StructuredGPConfig

__all__ = [
    "AtmosphereModel", "GPPrediction", "MultiOutputSparseGPState",
    "ResidualCollector", "RingBuffer", "Simple3DoFFeatureExtractor",
    "Simple3DoFGP", "SquaredExponentialARD", "StructuredGPConfig",
    "create_kernel", "fit_sparse_multi", "init_inducing_points",
    "predict_sparse_multi", "refit_sparse_multi", "simple_3dof_features",
    "sparse_lml",
]
