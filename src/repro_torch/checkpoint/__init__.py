"""Checkpoints (atomic two-phase commit) and the fingerprints that make a
store's snapshot durable, on the JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpoint import (
    latest_step,
    load_raw,
    save,
    tree_keys,
)
from repro_torch.checkpoint.defer_state import (
    manifests_compatible,
    plan_fingerprint,
    schedule_fingerprint,
)

__all__ = ["latest_step", "load_raw", "manifests_compatible",
           "plan_fingerprint", "save", "schedule_fingerprint", "tree_keys"]
