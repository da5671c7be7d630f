"""Fault tolerance of the training loop. The reference's gradient
compression (``runtime/compression.py``) waits for the distribution slice."""
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector, SimulatedFailure, Watchdog, run_with_restarts,
)
