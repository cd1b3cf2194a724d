"""Gaussian-process layer: kernels, exact and sparse GPs, features, the
structured residual models of both rockets, fast predictors and online
updating."""

from .exact_gp import (
    ExactGPState,
    GPPrediction,
    MultiOutputExactGPState,
    fit,
    fit_multi,
    log_marginal_likelihood,
    optimize_hyperparameters,
    predict,
    predict_multi,
    predict_one,
    refit,
    refit_multi,
    sample_posterior,
    sample_prior,
)
from .fast_gp import CachedGPPredictor, FastGPPredictor, SparseGPPredictor, create_fast_gp
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
from .kernels import (
    RBF,
    SE_ARD,
    Matern32,
    Matern52,
    ProductKernel,
    SquaredExponentialARD,
    SquaredExponentialIso,
    SumKernel,
    WhiteNoise,
    create_kernel,
    stack_kernels,
)
from .online_update import (
    DataBuffer,
    OnlineGPUpdater,
    OnlineStructuredGPUpdater,
    OnlineUpdateConfig,
    ResidualCollector,
)
from .sparse_gp import (
    MultiOutputSparseGPState,
    SparseGPState,
    fit_sparse,
    fit_sparse_multi,
    init_inducing_points,
    optimize_sparse_hyperparameters,
    predict_sparse,
    predict_sparse_multi,
    refit_sparse,
    refit_sparse_multi,
    sparse_lml,
    update_sparse,
    update_sparse_multi,
)
from .structured_gp import RingBuffer, Simple3DoFGP, StructuredGPConfig, StructuredRocketGP

__all__ = [
    "AtmosphereModel", "CachedGPPredictor", "CombinedFeatureExtractor", "DataBuffer",
    "ExactGPState", "FastGPPredictor", "GPPrediction", "Matern32", "Matern52",
    "MultiOutputExactGPState", "MultiOutputSparseGPState", "OnlineGPUpdater",
    "OnlineStructuredGPUpdater", "OnlineUpdateConfig", "ProductKernel", "RBF",
    "ResidualCollector", "RingBuffer", "RotationalFeatureExtractor", "SE_ARD",
    "Simple3DoFFeatureExtractor", "Simple3DoFGP", "SparseGPPredictor", "SparseGPState",
    "SquaredExponentialARD", "SquaredExponentialIso", "StructuredGPConfig",
    "StructuredRocketGP", "SumKernel", "TranslationalFeatureExtractor", "WhiteNoise",
    "combined_features", "create_fast_gp", "create_kernel", "fit", "fit_multi", "fit_sparse",
    "fit_sparse_multi", "init_inducing_points", "log_marginal_likelihood",
    "optimize_hyperparameters", "optimize_sparse_hyperparameters", "predict", "predict_multi",
    "predict_one", "predict_sparse", "predict_sparse_multi", "refit", "refit_multi",
    "refit_sparse", "refit_sparse_multi", "rotational_features", "sample_posterior",
    "sample_prior", "simple_3dof_features", "sparse_lml", "stack_kernels",
    "translational_features", "update_sparse", "update_sparse_multi",
]
