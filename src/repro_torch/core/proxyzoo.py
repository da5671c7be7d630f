"""Proxy model zoo reproducing the paper's Tables 3 and 4.

The paper evaluates 37 small image-classification models (Table 3: name,
layer count, internal-layer size ILS, model-weight memory footprint MWMF) and
8 large scaled AlexNet/VGG models (Table 4). We cannot ship MXNet weights,
so each entry becomes a *proxy model*: a real MLP whose serialized byte size
matches MWMF and whose layer count matches the table — byte-identical I/O
behaviour, and a real (if simple) forward pass for the compute term.

TrIMS is agnostic to the compute pattern (paper §6), so matching the
load-path byte distribution is what the reproduction requires.

A copy of the JAX package's ``core/proxyzoo.py``: the tables, the specs and
the weights are the same numpy, so both packages write byte-equal stores.
``proxy_forward`` computes in torch on the weights' device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

import torch

from repro_torch.core.mrm import ModelKey
from repro_torch.core.store import DiskStore
from repro_torch.device import tensor_from_numpy

MB = 1 << 20

# (id, name, n_layers, ILS_MB, MWMF_MB) — paper Table 3
SMALL_MODELS: List[Tuple[int, str, int, int, float]] = [
    (1, "AlexNet", 16, 516, 238),
    (2, "GoogLeNet", 116, 111, 27),
    (3, "CaffeNet", 16, 512, 233),
    (4, "RCNN-ILSVRC13", 16, 479, 221),
    (5, "DPN68", 361, 122, 49),
    (6, "DPN92", 481, 340, 145),
    (7, "Inception-v3", 472, 257, 92),
    (8, "Inception-v4", 747, 399, 164),
    (9, "InceptionBN-v2", 416, 313, 129),
    (10, "InceptionBN-v3", 416, 142, 44),
    (11, "Inception-ResNet-v2", 1102, 493, 214),
    (12, "LocationNet", 514, 666, 285),
    (13, "NIN", 24, 131, 29),
    (14, "ResNet101", 526, 423, 170),
    (15, "ResNet101-v2", 522, 428, 171),
    (16, "ResNet152", 777, 548, 231),
    (17, "ResNet152-11k", 769, 721, 311),
    (18, "ResNet152-v2", 761, 340, 231),
    (19, "ResNet18-v2", 99, 154, 45),
    (20, "ResNet200-v2", 1009, 589, 248),
    (21, "ResNet269-v2", 1346, 889, 391),
    (22, "ResNet34-v2", 179, 222, 84),
    (23, "ResNet50", 268, 270, 98),
    (24, "ResNet50-v2", 259, 275, 98),
    (25, "ResNeXt101", 526, 375, 170),
    (26, "ResNeXt101-32x4d", 522, 378, 170),
    (27, "ResNeXt26-32x4d", 147, 147, 59),
    (28, "ResNeXt50", 271, 222, 96),
    (29, "ResNeXt50-32x4d", 267, 224, 96),
    (30, "SqueezeNet-v1.0", 52, 34, 4.8),
    (31, "SqueezeNet-v1.1", 52, 28, 4.8),
    (32, "VGG16", 32, 1228, 528),
    (33, "VGG16-SOD", 32, 1198, 514),
    (34, "VGG16-SOS", 32, 1195, 513),
    (35, "VGG19", 38, 1270, 549),
    (36, "WRN50-v2", 267, 758, 264),
    (37, "Xception", 236, 244, 88),
]

# (id, name, input_dim, MWMF_MB) — paper Table 4 (scaled AlexNet/VGG16)
LARGE_MODELS: List[Tuple[int, str, int, float]] = [
    (1, "AlexNet-S1", 227, 238),
    (2, "AlexNet-S2", 454, 770),
    (3, "AlexNet-S3", 681, 1694),
    (4, "AlexNet-S4", 908, 3010),
    (5, "VGG16-S1", 224, 528),
    (6, "VGG16-S2", 448, 1704),
    (7, "VGG16-S3", 672, 3664),
    (8, "VGG16-S4", 896, 6408),
]


@dataclass(frozen=True)
class ProxySpec:
    model_id: int
    name: str
    n_layers: int
    mwmf_bytes: int
    ils_bytes: int  # internal layer size = activation footprint


def small_specs(scale: float = 1.0) -> List[ProxySpec]:
    """``scale`` shrinks every model uniformly (CI-friendly benchmarks)."""
    return [ProxySpec(i, n, max(2, int(l * min(1.0, scale * 4))),
                      int(mw * MB * scale), int(ils * MB * scale))
            for i, n, l, ils, mw in SMALL_MODELS]


def large_specs(scale: float = 1.0) -> List[ProxySpec]:
    return [ProxySpec(i, n, 16, int(mw * MB * scale), int(2 * mw * MB * scale))
            for i, n, dim, mw in LARGE_MODELS]


def build_proxy_tensors(spec: ProxySpec, dtype=np.float32,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """MLP weights whose total bytes == spec.mwmf_bytes (+-1 row).

    Layout mirrors real nets: a few large tensors + many small biases, so
    layer-granularity sharing and partial reads are meaningfully exercised.
    """
    itemsize = np.dtype(dtype).itemsize
    n_elem = spec.mwmf_bytes // itemsize
    L = max(2, min(spec.n_layers // 2, 64))  # weight matrices (biases separate)
    per_layer = n_elem // L
    d = max(8, int(math.sqrt(per_layer)))
    rng = np.random.default_rng(seed + spec.model_id)
    tensors: Dict[str, np.ndarray] = {}
    used = 0
    for i in range(L - 1):
        w = rng.standard_normal((d, per_layer // d), dtype=np.float32).astype(dtype)
        b = np.zeros((per_layer // d,), dtype)
        tensors[f"layer{i:03d}_weight"] = w * 0.02
        tensors[f"layer{i:03d}_bias"] = b
        used += w.size + b.size
    rem = max(d, n_elem - used)
    tensors[f"layer{L-1:03d}_weight"] = (
        rng.standard_normal((d, max(1, rem // d)), dtype=np.float32) * 0.02).astype(dtype)
    return tensors


def proxy_forward(weights: Dict[str, object], x) -> torch.Tensor:
    """Reference 'inference': chain matmuls through every weight matrix.

    ``h = tanh(h @ w)`` through the ``*_weight`` tensors in sorted name
    order, on the weights' device (tensors as the MRM hands them out, or
    numpy arrays, which run on the CPU); ``x`` is a numpy array or a tensor.
    Returns a float32 tensor on that device. A plain matrix product, outside
    any kernel, as the JAX package's numpy version is.
    """
    names = [n for n in sorted(weights) if n.endswith("_weight")]
    first = weights[names[0]] if names else None
    device = first.device if torch.is_tensor(first) else torch.device("cpu")
    h = _on(x, device)
    for name in names:
        w = _on(weights[name], device)
        if h.shape[-1] != w.shape[0]:
            # project into layer input dim (proxy nets are not dim-matched)
            h = _resize(h, (*h.shape[:-1], w.shape[0]))
        h = torch.tanh(h @ w)
    return h


def _on(a, device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else tensor_from_numpy(a, device)
    return t.to(device=device, dtype=torch.float32)


def _resize(h: torch.Tensor, shape) -> torch.Tensor:
    """``np.resize``: the flattened ``h`` repeated cyclically (across batch
    rows, not within each row) or truncated to fill ``shape``."""
    n = math.prod(shape)
    flat = h.reshape(-1)
    return flat.repeat(-(-n // flat.numel()))[:n].reshape(shape)


def proxy_flops(spec: ProxySpec) -> float:
    """2 * weights FLOPs for batch-1 inference."""
    return 2.0 * spec.mwmf_bytes / 4


def populate_store(store: DiskStore, specs: List[ProxySpec],
                   framework: str = "repro-torch") -> Dict[str, ModelKey]:
    keys = {}
    for spec in specs:
        key = ModelKey(framework, spec.name, "1")
        if not store.contains(key):
            store.put(key, build_proxy_tensors(spec),
                      meta={"model_id": spec.model_id, "mwmf": spec.mwmf_bytes,
                            "ils": spec.ils_bytes})
        keys[spec.name] = key
    return keys
