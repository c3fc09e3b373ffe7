"""Model registry of the port: config family -> model implementation.

``dense`` is ``DecoderLM`` (SwiGLU or GELU MLP), ``ssm`` the xLSTM model,
``hybrid`` the Hymba model, ``encdec`` the encoder-decoder; MoE and VLM
are not ported yet. :func:`from_jax_params` builds any ported family and fills it with a
JAX parameter tree.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hymba import HymbaModel
from repro_torch.models.transformer import DecoderLM, load_jax_params
from repro_torch.models.xlstm_lm import XLSTMModel

_FAMILIES = {"dense": DecoderLM, "ssm": XLSTMModel, "hybrid": HymbaModel,
             "encdec": EncDecModel}
# families of the JAX package's registry that are not ported yet
_NOT_PORTED = ("moe", "vlm")


def build_model(cfg, *, device="cuda", seed: int = 0,
                attention: str = "kernel"):
    """The model of ``cfg`` with random weights from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{sorted(_FAMILIES)})")
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family!r}") from None
    return cls(cfg, device=device, seed=seed, attention=attention)


def from_jax_params(cfg, tree: Mapping, *, device="cuda",
                    attention: str = "kernel"):
    """The model of ``cfg``'s family on ``device`` (the card unless the
    caller asks for the CPU) holding the JAX ``split_params`` tree's
    weights (numpy arrays), leaf by leaf; raises on a missing, extra or
    misshaped leaf."""
    return load_jax_params(build_model(cfg, device=device,
                                       attention=attention), tree)
