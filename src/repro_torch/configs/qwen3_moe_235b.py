"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128 experts, top-8."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=0, vocab=151936,
        head_dim=128,
        n_experts=128, top_k=8, d_ff_expert=1536,
        moe_impl="ep",
        rope_theta=1_000_000.0,
        microbatches={"train_4k": 2},
        notes="94L d4096 64H (GQA kv=4) MoE 128e top-8 ff_e1536 v151936",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=512,
        head_dim=16,
        n_experts=4, top_k=2, d_ff_expert=96,
        remat="none",
    )
