"""Model registry of the port: config family -> model implementation.

``dense`` (SwiGLU or GELU MLP), ``moe`` and ``vlm`` are ``DecoderLM``,
``ssm`` the xLSTM model, ``hybrid`` the Hymba model, ``encdec`` the
encoder-decoder: every family of the JAX package's registry.
:func:`from_jax_params` builds any family and fills it with a JAX
parameter tree.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hymba import HymbaModel
from repro_torch.models.transformer import DecoderLM, load_jax_params
from repro_torch.models.xlstm_lm import XLSTMModel

_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
             "ssm": XLSTMModel, "hybrid": HymbaModel, "encdec": EncDecModel}


def build_model(cfg, *, device="cuda", seed: int = 0,
                impl: str = "kernel", model_ranks: int | None = None):
    """The model of ``cfg`` with random weights from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU).
    ``model_ranks`` (``DecoderLM`` only) is the size of the model axis its
    MoE layers run over (``DecoderLM._moe``); ``None``: no model axis."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family!r}") from None
    ranks = {} if model_ranks is None else {"model_ranks": model_ranks}
    return cls(cfg, device=device, seed=seed, impl=impl, **ranks)


def from_jax_params(cfg, tree: Mapping, *, device="cuda",
                    impl: str = "kernel", model_ranks: int | None = None):
    """The model of ``cfg``'s family on ``device`` (the card unless the
    caller asks for the CPU) holding the JAX ``split_params`` tree's
    weights (numpy arrays), leaf by leaf; raises on a missing, extra or
    misshaped leaf."""
    return load_jax_params(build_model(cfg, device=device, impl=impl,
                                       model_ranks=model_ranks), tree)
