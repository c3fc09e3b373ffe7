"""Kimi-K2-1T-A32B [arXiv:2501.kimi2]: trillion-param MoE, 384 experts top-8,
1 shared expert, first layer dense (DeepSeek-V3-style layout)."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=18432, vocab=163840,
        head_dim=128,
        n_experts=384, top_k=8, d_ff_expert=2048,
        moe_impl="ep",
        n_shared_experts=1, first_dense_layers=1,
        rope_theta=50_000.0,
        optimizer="adafactor",
        microbatches={"train_4k": 4},
        notes="61L d7168 64H (GQA kv=8) MoE 384e top-8 +1 shared, v163840",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        head_dim=16,
        n_experts=4, top_k=2, d_ff_expert=96,
        n_shared_experts=1, first_dense_layers=1,
        remat="none",
    )
