"""Model registry of the port: config family -> model implementation."""

from __future__ import annotations

from repro_torch.models.transformer import DecoderLM

_FAMILIES = {"dense": DecoderLM}
# families of the JAX package's registry that are not ported yet
_NOT_PORTED = ("moe", "vlm", "ssm", "hybrid", "encdec")


def build_model(cfg, *, device="cuda", seed: int = 0,
                attention: str = "kernel"):
    """The model of ``cfg`` with random weights from ``seed`` on
    ``device``."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{sorted(_FAMILIES)})")
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family!r}") from None
    return cls(cfg, device=device, seed=seed, attention=attention)
