"""Model functions over plain dicts of tensors, every family of the JAX package."""
from repro_torch.models.model import (  # noqa: F401
    decode_step, forward, greedy_generate, init_cache, init_params, loss_fn, prefill,
)
