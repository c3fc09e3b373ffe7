"""LLaVA-NeXT-34B backbone [hf:llava-hf]: VLM; anyres vision frontend is a
stub — train/prefill inputs are precomputed patch+text embeddings."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000,
        rope_theta=5_000_000.0,
        microbatches={"train_4k": 2},
        notes="60L d7168 56H (GQA kv=8) ff20480 v64000; embeds-input backbone",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=512,
        remat="none",
    )
