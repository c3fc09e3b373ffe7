"""InternLM2-1.8B [arXiv:2403.17297]: dense GQA."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544,
        rope_theta=1_000_000.0,
        remat="dots",
        microbatches={"train_4k": 1},
        notes="24L d2048 16H (GQA kv=8) ff8192 v92544",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        remat="none",
    )
