"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _llamav
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.deepseek_7b import CONFIG as _dsk7
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _moonshot, _qwen3moe, _llamav, _nemo, _dsk7,
        _olmo, _qwen110, _jamba, _mamba2, _seamless,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
