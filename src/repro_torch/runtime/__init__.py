"""Fault tolerance of the training loop, and the int8 cross-pod gradient
all-reduce (``runtime/compression.py``)."""
from repro_torch.runtime.compression import (  # noqa: F401
    make_compressed_grad_fn, quantized_allreduce, tree_quantized_allreduce,
)
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector, SimulatedFailure, Watchdog, run_with_restarts,
)
