"""Paper core (PyTorch port): TM forward pass and learning, the clause
index and its maintenance, evaluation engines, bundle API, session and
estimator."""
from repro_torch.core.types import (
    TMConfig,
    TMState,
    VoteAccumulator,
    clause_polarity,
    include_mask,
    init_tm,
    literals_from_input,
)
from repro_torch.core.tm import (
    FeedbackRands,
    SampleDraws,
    accuracy,
    clause_votes,
    dense_clause_outputs,
    draw_feedback_rands,
    draw_negatives,
    draw_sample_draws,
    predict,
    scores,
    update_batch_parallel,
    update_batch_sequential,
    update_sample,
)
from repro_torch.core.indexing import (
    ClauseIndex,
    CompactClauses,
    Event,
    EventBuffer,
    apply_events,
    build_index,
    compact,
    compact_apply_events,
    compact_eval,
    compact_scores,
    delete,
    dense_work,
    empty_index,
    events_from_transition,
    index_update,
    indexed_scores,
    indexed_work,
    insert,
    validate,
    validate_compact,
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
    sync_caches,
    train_step,
)
from repro_torch.core.distributed import (
    ClauseGeometry,
    ShardedBundle,
    clause_geometry,
)
from repro_torch.core.session import (
    TMSession,
    Topology,
    TsetlinMachine,
)

__all__ = [
    "TMConfig", "TMState", "VoteAccumulator", "clause_polarity", "include_mask", "init_tm",
    "literals_from_input", "FeedbackRands", "SampleDraws", "accuracy",
    "clause_votes", "dense_clause_outputs", "draw_feedback_rands",
    "draw_negatives", "draw_sample_draws", "predict", "scores",
    "update_batch_parallel", "update_batch_sequential", "update_sample",
    "ClauseIndex", "CompactClauses", "Event", "EventBuffer", "apply_events",
    "build_index", "compact", "compact_apply_events", "compact_eval",
    "compact_scores", "delete", "dense_work", "empty_index",
    "events_from_transition", "index_update", "indexed_scores",
    "indexed_work", "insert", "validate", "validate_compact", "EvalEngine", "cache_provider", "get_engine",
    "register_engine", "registered_engines", "DEFAULT_ENGINE", "TMBundle",
    "bundle_predict", "bundle_scores", "cache_keys_for", "init_bundle",
    "sync_caches", "train_step", "ClauseGeometry", "ShardedBundle",
    "clause_geometry", "TMSession", "Topology", "TsetlinMachine",
]
