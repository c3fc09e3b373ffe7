"""Pipeline parallelism on the stacked layout: the GPipe schedule."""

from repro_torch.sharding.pipeline import bubble_fraction, pipeline_apply

__all__ = ["bubble_fraction", "pipeline_apply"]
