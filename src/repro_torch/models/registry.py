"""Model registry of the port: config family -> model implementation.

``dense`` (SwiGLU or GELU MLP), ``moe`` and ``vlm`` are ``DecoderLM``,
``ssm`` the xLSTM model, ``hybrid`` the Hymba model, ``encdec`` the
encoder-decoder: every family of the JAX package's registry.
:func:`from_jax_params` builds any family and fills it with a JAX
parameter tree; :func:`abstract_model` builds any family without
parameters, for the production-mesh planner (``launch/steps.py``), which
passes its trees.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hymba import HymbaModel
from repro_torch.models.transformer import DecoderLM, load_jax_params
from repro_torch.models.xlstm_lm import XLSTMModel

_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
             "ssm": XLSTMModel, "hybrid": HymbaModel, "encdec": EncDecModel}


def _family(cfg):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family!r}") from None


def build_model(cfg, *, device="cuda", seed: int = 0,
                impl: str = "kernel", model_ranks: int | None = None):
    """The model of ``cfg`` with random weights from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU).
    ``model_ranks`` (``DecoderLM`` only) is the size of the model axis its
    MoE layers run over (``DecoderLM._moe``); ``None``: no model axis."""
    cls = _family(cfg)
    ranks = {} if model_ranks is None else {"model_ranks": model_ranks}
    return cls(cfg, device=device, seed=seed, impl=impl, **ranks)


def abstract_model(cfg):
    """The model of ``cfg``'s family holding no parameters: its
    ``loss``, ``prefill`` and ``decode_step`` take the planner's trees
    (``params=``, and the caches a step writes into), and ``input_specs``
    / ``input_axes`` give its inputs, as JAX's."""
    return _family(cfg)(cfg, abstract=True)


def from_jax_params(cfg, tree: Mapping, *, device="cuda",
                    impl: str = "kernel", model_ranks: int | None = None):
    """The model of ``cfg``'s family on ``device`` (the card unless the
    caller asks for the CPU) holding the JAX ``split_params`` tree's
    weights (numpy arrays), leaf by leaf; raises on a missing, extra or
    misshaped leaf."""
    return load_jax_params(build_model(cfg, device=device, impl=impl,
                                       model_ranks=model_ranks), tree)
