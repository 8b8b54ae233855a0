"""Checkpoints: a torch-side ``Checkpointer`` for the reference's on-disk
layout, and the schema-v1 TM store shared with the reference package."""
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.tm_store import (
    SCHEMA_VERSION,
    CheckpointMismatch,
    checkpoint_tree,
    config_fingerprint,
    load_tm,
    save_tm,
    validate_meta,
)

__all__ = [
    "Checkpointer", "SCHEMA_VERSION", "CheckpointMismatch",
    "checkpoint_tree", "config_fingerprint", "load_tm", "save_tm",
    "validate_meta",
]
