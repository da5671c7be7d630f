from repro_torch.serving.engine import (  # noqa: F401
    FRAMEWORK, InferenceEngine, Request, RequestStats, ServableModel,
    ServingWorkers, arch_signature, publish_model,
)
from repro_torch.serving.prefix_cache import PrefixKVStore, prompt_key  # noqa: F401
from repro_torch.serving.weights_io import (  # noqa: F401
    flat_to_params, params_to_flat, to_torch_tree,
)
