"""Paper core (PyTorch port): TM forward pass, clause index construction,
evaluation engines, bundle API, session and estimator."""
from repro_torch.core.types import (
    TMConfig,
    TMState,
    clause_polarity,
    include_mask,
    init_tm,
    literals_from_input,
)
from repro_torch.core.tm import (
    accuracy,
    clause_votes,
    dense_clause_outputs,
    predict,
    scores,
)
from repro_torch.core.indexing import (
    ClauseIndex,
    build_index,
    empty_index,
    validate,
)
from repro_torch.core.engines import (
    EvalEngine,
    cache_provider,
    get_engine,
    register_engine,
    registered_engines,
)
from repro_torch.core.api import (
    DEFAULT_ENGINE,
    TMBundle,
    bundle_predict,
    bundle_scores,
    cache_keys_for,
    init_bundle,
)
from repro_torch.core.session import (
    TMSession,
    Topology,
    TsetlinMachine,
)

__all__ = [
    "TMConfig", "TMState", "clause_polarity", "include_mask", "init_tm",
    "literals_from_input", "accuracy", "clause_votes", "dense_clause_outputs",
    "predict", "scores", "ClauseIndex", "build_index", "empty_index",
    "validate", "EvalEngine", "cache_provider", "get_engine",
    "register_engine", "registered_engines", "DEFAULT_ENGINE", "TMBundle",
    "bundle_predict", "bundle_scores", "cache_keys_for", "init_bundle",
    "TMSession", "Topology", "TsetlinMachine",
]
