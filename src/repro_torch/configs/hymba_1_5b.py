"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + Mamba heads per block.

Meta-tokens are a frontend-level feature (out of backbone scope; DESIGN.md §9).
Sliding-window attention everywhere except first/middle/last global layers.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001,
        ssm_state=16, ssm_expand=2,
        sliding_window=1024, full_attn_layers=(0, 15, 31),
        remat="dots",
        microbatches={"train_4k": 1},
        notes="32L d1600 25H (GQA kv=5) ff5504 v32001 ssm_state=16",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        ssm_state=4, ssm_expand=2,
        sliding_window=16, full_attn_layers=(0,),
        remat="none",
    )
