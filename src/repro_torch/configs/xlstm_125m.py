"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks; O(1) decode state."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        slstm_every=4, ssm_expand=2,
        remat="none", scan_layers=False,
        microbatches={"train_4k": 1},
        notes="12L d768 4H; every 4th block sLSTM, rest mLSTM (pf=2)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=512,
        slstm_every=2, ssm_expand=2,
        remat="none", scan_layers=False,
    )
