"""The sharded commutative KV serving tier on the stacked layout, with its
write-ahead journal."""

from repro_torch.serve.frontend import BatchedFrontend, DrainBacklog
from repro_torch.serve.journal import UpdateJournal
from repro_torch.serve.kv import KVConfig, ShardedKV, serving_plan

__all__ = ["BatchedFrontend", "DrainBacklog", "KVConfig", "ShardedKV",
           "UpdateJournal", "serving_plan"]
