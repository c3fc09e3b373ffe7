"""The synthetic training data stream (numpy, bitwise the JAX package's)."""

from repro_torch.data.pipeline import (DataConfig, Prefetcher, batch_at,
                                       data_config_for, iterate)

__all__ = ["DataConfig", "Prefetcher", "batch_at", "data_config_for",
           "iterate"]
