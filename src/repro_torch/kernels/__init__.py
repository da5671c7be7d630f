"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions."""
from repro_torch.kernels import ops, ref  # noqa: F401
