"""Architecture configuration schema and registry of the port.

The port's own copy of the JAX package's ``repro/configs/base.py``
``ArchConfig`` (every field, the same derived sizes), with ``param_dtype``
a ``torch.dtype``, and its ``SHAPES`` and ``applicable_shapes``. Every
config of ``ARCH_IDS`` is ported; an arch whose module is missing raises
:class:`NotImplementedError` naming it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    mlp: str = "swiglu"                     # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gshard"   # gshard (sort dispatch) | ep (shard_map local)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    sliding_window: int = 0                 # 0 = all layers full attention
    full_attn_layers: tuple = ()            # layer indices kept full-attn

    # xLSTM
    slstm_every: int = 0                    # every k-th block is sLSTM

    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # numerics / schedule
    dtype: str = "bfloat16"
    optimizer: str = "adamw"                # adamw | adafactor
    remat: str = "full"                     # full | dots | none
    scan_layers: bool = True
    # microbatches per shape name (gradient accumulation = CCache soft-merge)
    microbatches: dict = dataclasses.field(default_factory=dict)
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (TPU lane + TP divisibility).

        Standard practice (MaxText/Megatron pad the embedding table); only
        seamless (256206->256256) and hymba (32001->32128) change. Labels
        stay < vocab, so the loss is unaffected.
        """
        return -(-self.vocab // 128) * 128

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (dense-equivalent; MoE counts all experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        ffn_mats = 2 if self.mlp == "gelu" else 3
        att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            moe_ffn = self.n_experts * 3 * d * self.d_ff_expert \
                + d * self.n_experts \
                + self.n_shared_experts * 3 * d * self.d_ff_expert
            dense_ffn = 3 * d * self.d_ff if self.d_ff else 3 * d * (
                self.d_ff_expert * 4)
            n_moe = self.n_layers - self.first_dense_layers
            blocks = n_moe * (att + moe_ffn) + self.first_dense_layers * (
                att + dense_ffn)
        elif self.family == "ssm":
            # xLSTM: rough per-block count (mLSTM dominated)
            d_in = self.ssm_expand * d
            blocks = self.n_layers * (2 * d * d_in + 4 * d_in * d_in // 4)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state + d // 16)
            blocks = self.n_layers * (att + 3 * d * self.d_ff + ssm)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (att + 2 * d * self.d_ff)
            dec = self.n_dec_layers * (2 * att + 2 * d * self.d_ff)
            blocks = enc + dec
        else:
            blocks = self.n_layers * (att + ffn_mats * d * self.d_ff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return blocks + emb

    def n_active_params(self) -> int:
        """Active (per-token) parameters — the MoE MODEL_FLOPS basis."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        att = d * self.resolved_head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.resolved_head_dim * d
        act_ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff_expert \
            + d * self.n_experts
        dense_ffn = 3 * d * (self.d_ff or self.d_ff_expert * 4)
        n_moe = self.n_layers - self.first_dense_layers
        blocks = n_moe * (att + act_ffn) + self.first_dense_layers * (att + dense_ffn)
        return blocks + self.vocab * d * (1 if self.tie_embeddings else 2)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "qwen1_5_0_5b",
    "granite_34b",
    "llama3_405b",
    "internlm2_1_8b",
    "llava_next_34b",
    "xlstm_125m",
    "seamless_m4t_medium",
    "hymba_1_5b",
    "qwen3_moe_235b",
    "kimi_k2_1t",
]

# Canonical --arch ids (dash form) -> module name.
ARCH_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}

# the configs ported so far: all of ARCH_IDS
PORTED = ("qwen1_5_0_5b", "internlm2_1_8b", "xlstm_125m", "hymba_1_5b",
          "granite_34b", "seamless_m4t_medium", "qwen3_moe_235b",
          "kimi_k2_1t", "llava_next_34b", "llama3_405b")


def _module(arch: str):
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    try:
        return importlib.import_module(f"repro_torch.configs.{arch}")
    except ModuleNotFoundError:
        raise NotImplementedError(
            f"arch {arch!r}: its config is not ported yet (ported: "
            f"{', '.join(PORTED)})") from None


def get_config(arch: str) -> ArchConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke_config()


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Which of the 4 shapes run for this arch (brief's skip rules)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    # long_500k needs sub-quadratic context state: SSM / hybrid only.
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return out
