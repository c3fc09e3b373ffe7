"""SeamlessM4T-medium backbone [arXiv:2308.11596]: enc-dec, 256k vocab.

Speech frontend is a stub: encoder consumes precomputed frame embeddings.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=256206,
        n_enc_layers=12, n_dec_layers=12,
        norm="layernorm", mlp="gelu", tie_embeddings=True,
        remat="dots",
        microbatches={"train_4k": 1},
        notes="12L enc + 12L dec, d1024 16H ff4096 v256206",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512,
        n_enc_layers=2, n_dec_layers=2,
        norm="layernorm", mlp="gelu", tie_embeddings=True,
        remat="none",
    )
