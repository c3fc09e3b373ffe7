from repro_torch.optim.optimizers import (
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import constant, warmup_cosine
