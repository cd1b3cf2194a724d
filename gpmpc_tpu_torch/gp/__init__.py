"""Gaussian-process layer: features, kernels, sparse GPs, the structured
residual models of both rockets and online updating."""

from .exact_gp import GPPrediction
from .features import (
    AtmosphereModel,
    CombinedFeatureExtractor,
    RotationalFeatureExtractor,
    Simple3DoFFeatureExtractor,
    TranslationalFeatureExtractor,
    combined_features,
    rotational_features,
    simple_3dof_features,
    translational_features,
)
from .kernels import SquaredExponentialARD, create_kernel
from .online_update import (
    DataBuffer,
    OnlineGPUpdater,
    OnlineStructuredGPUpdater,
    OnlineUpdateConfig,
    ResidualCollector,
)
from .sparse_gp import (
    MultiOutputSparseGPState,
    fit_sparse_multi,
    init_inducing_points,
    predict_sparse_multi,
    refit_sparse_multi,
    sparse_lml,
)
from .structured_gp import RingBuffer, Simple3DoFGP, StructuredGPConfig, StructuredRocketGP

__all__ = [
    "AtmosphereModel", "CombinedFeatureExtractor", "DataBuffer", "GPPrediction",
    "MultiOutputSparseGPState", "OnlineGPUpdater", "OnlineStructuredGPUpdater",
    "OnlineUpdateConfig", "ResidualCollector", "RingBuffer", "RotationalFeatureExtractor",
    "Simple3DoFFeatureExtractor", "Simple3DoFGP", "SquaredExponentialARD",
    "StructuredGPConfig", "StructuredRocketGP", "TranslationalFeatureExtractor",
    "combined_features", "create_kernel", "fit_sparse_multi", "init_inducing_points",
    "predict_sparse_multi", "refit_sparse_multi", "rotational_features",
    "simple_3dof_features", "sparse_lml", "translational_features",
]
