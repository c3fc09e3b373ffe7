"""The fault-tolerant train driver, elastic restore onto another topology
(``elastic``) and the chaos harness that holds recovery to the bit
(``chaos``)."""

from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.runtime.elastic import (
    RestoreReport,
    effective_invariants,
    elastic_restore,
    rescale_hyperparams,
)

__all__ = ["DriverConfig", "RestoreReport", "TrainDriver",
           "effective_invariants", "elastic_restore", "rescale_hyperparams"]
