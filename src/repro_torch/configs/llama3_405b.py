"""Llama-3.1-405B [arXiv:2407.21783]: dense GQA, 128k vocab."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256,
        head_dim=128, rope_theta=500_000.0,
        optimizer="adafactor",
        microbatches={"train_4k": 2},
        notes="126L d16384 128H (GQA kv=8) ff53248 v128256",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=512,
        head_dim=8,
        remat="none",
    )
