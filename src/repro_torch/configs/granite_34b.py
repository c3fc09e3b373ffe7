"""Granite-34B-Code [arXiv:2405.04324]: llama-arch MQA (kv=1) code model."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152,
        head_dim=128, tie_embeddings=True, rope_theta=10_000.0,
        mlp="gelu",   # 2-matrix MLP lands the 34B total (swiglu would be 47B)
        microbatches={"train_4k": 2},
        notes="88L d6144 48H (MQA kv=1) ff24576 v49152",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=512,
        head_dim=16, tie_embeddings=True,
        remat="none",
    )
