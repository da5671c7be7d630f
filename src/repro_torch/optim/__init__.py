"""AdamW and learning-rate schedules over the port's dict-of-tensors params."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw, clip_by_global_norm, global_norm,
)
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
