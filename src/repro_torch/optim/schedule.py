"""Learning-rate schedules: functions of the optimizer's int32 step tensor
returning a float32 0-d tensor on the step's device, computed in float32 in
the reference's order of operations."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(1, warmup_steps)
        prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
