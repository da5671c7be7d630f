"""TrIMS core for the PyTorch port: the model store, the multi-tier model
cache and its MRM, the transparent client, and the cost models. These are
copies of the JAX package's modules (which this package never imports),
with the device-facing pieces in torch."""
from repro_torch.core.layerplan import (  # noqa: F401
    LayerWindow, StreamAssembler, build_layer_plan, plan_for_file,
)
