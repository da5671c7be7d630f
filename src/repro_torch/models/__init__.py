"""Model functions over plain dicts of tensors (DENSE and MoE families)."""
from repro_torch.models.model import (  # noqa: F401
    decode_step, greedy_generate, init_cache, init_params, prefill,
)
