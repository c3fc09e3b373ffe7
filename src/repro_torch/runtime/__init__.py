"""The fault-tolerant train driver (``runtime/elastic`` and ``chaos`` are
not ported yet)."""

from repro_torch.runtime.driver import DriverConfig, TrainDriver

__all__ = ["DriverConfig", "TrainDriver"]
