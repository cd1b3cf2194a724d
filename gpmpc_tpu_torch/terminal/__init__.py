"""Terminal-set layer: sampled safe sets, local KNN sets, convex hulls and
Q-functions (counterpart of ``gpmpc_tpu/terminal``), lanes first."""

from .convex_hull import (
    CasADiConvexHullConstraint,
    ConvexHullConstraint,
    HullProjection,
    TerminalSetManager,
    contains,
    hull_constraint_rows,
    project_onto_hull,
)
from .local_safe_set import (
    KNNResult,
    LocalSafeSet,
    LocalSafeSetConfig,
    MultiResolutionLocalSafeSet,
    adaptive_k,
    default_state_weights,
    interpolate_q,
    knn_query,
)
from .q_function import (
    GPQFunction,
    InverseDistanceQFunction,
    IterativeQFunction,
    LocalLinearQFunction,
    QFunctionManager,
    idw_q,
    iteration_q_values,
    local_linear_q,
)
from .safe_set import (
    FuelAwareSafeSet,
    MemoryOptimizedSafeSet,
    SafeSet,
    SampledSafeSet,
    StreamingSafeSet,
    cost_to_go,
    knn_bucket,
    merge_safe_sets,
    prune,
    prune_diversity,
    prune_fifo,
    prune_quality,
    trim,
)

__all__ = [
    "CasADiConvexHullConstraint", "ConvexHullConstraint", "FuelAwareSafeSet", "GPQFunction",
    "HullProjection", "InverseDistanceQFunction", "IterativeQFunction", "KNNResult",
    "LocalLinearQFunction", "LocalSafeSet", "LocalSafeSetConfig", "MemoryOptimizedSafeSet",
    "MultiResolutionLocalSafeSet", "QFunctionManager", "SafeSet", "SampledSafeSet",
    "StreamingSafeSet", "TerminalSetManager", "adaptive_k", "contains", "cost_to_go",
    "default_state_weights", "hull_constraint_rows", "idw_q", "interpolate_q",
    "iteration_q_values", "knn_query", "local_linear_q", "merge_safe_sets",
    "project_onto_hull", "knn_bucket", "prune", "prune_diversity", "prune_fifo",
    "prune_quality", "trim",
]
