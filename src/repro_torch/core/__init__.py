"""TrIMS core for the PyTorch port: the model store, the multi-tier model
cache and its MRM, the transparent client, the cost models, cross-process
shm IPC, the transport layer, the CLOUD object store and its codecs, and
the FaaS isolation layer. These are copies of the JAX package's modules
(which this package never imports), with the device-facing pieces in torch.
"""
from repro_torch.core.cache import (  # noqa: F401
    CacheEntry, CapacityError, CostAware, EvictionPolicy, FIFO, LCU, LRU,
    Largest, POLICIES, Tier, TierCache, TierHierarchy, make_policy,
)
from repro_torch.core.client import (  # noqa: F401
    LoadedModel, TrimsClient, cold_load, free_model, load_model,
)
from repro_torch.core.codec import CODECS, Codec, get_codec, sample_ratio  # noqa: F401
from repro_torch.core.costmodel import (  # noqa: F401
    HardwareModel, get_hardware, pipelined_stage_time, streaming_ttfl_time,
)
from repro_torch.core.faas import Container, FaaSPlatform, IsolationError, Router  # noqa: F401
from repro_torch.core.layerplan import (  # noqa: F401
    LayerWindow, StreamAssembler, build_layer_plan, plan_for_file,
)
from repro_torch.core.objectstore import ObjectStore  # noqa: F401
from repro_torch.core.mrm import (  # noqa: F401
    LoadFuture, MRM, ModelHandle, ModelKey, OpenTimings,
)
from repro_torch.core.pipeline import (  # noqa: F401
    PipelineReport, plan_chunks, run_pipeline,
)
from repro_torch.core.sharing import get_constants, plan_granularity, rho  # noqa: F401
from repro_torch.core.slo import (  # noqa: F401
    NextUsePredictor, ReloadCostEstimator, SLOState,
)
from repro_torch.core.store import CloudStore, DiskStore, ModelFile, write_model  # noqa: F401
from repro_torch.core.tenant import (  # noqa: F401
    AdmissionError, RequestContext, TenantQuota, TenantRegistry,
)
from repro_torch.core.transport import (  # noqa: F401
    LoopbackTransport, RemoteError, SocketServer, SocketTransport,
    TransportError,
)
