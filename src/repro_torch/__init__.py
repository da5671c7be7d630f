"""PyTorch + CUDA port of the TrIMS reproduction (``src/repro`` is the JAX
reference it is held against). It imports torch and numpy, never JAX or the
``repro`` package."""

__version__ = "1.0.0"
