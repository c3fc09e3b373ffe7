"""Checkpoints (atomic two-phase commit), restore, and the fingerprints and
manifests that make a store's snapshot or a deferred train step's state
durable, on the JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpoint import (
    from_raw,
    latest_step,
    load_raw,
    restore,
    restore_resharded,
    save,
    tree_keys,
)
from repro_torch.checkpoint.defer_state import (
    defer_manifest,
    defer_state_spec,
    manifests_compatible,
    plan_fingerprint,
    schedule_fingerprint,
)

__all__ = ["defer_manifest", "defer_state_spec", "from_raw", "latest_step",
           "load_raw", "manifests_compatible", "plan_fingerprint", "restore",
           "restore_resharded", "save", "schedule_fingerprint", "tree_keys"]
