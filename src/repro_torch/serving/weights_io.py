"""Params tree <-> flat named tensors (the .trims wire format), and the
weight bridge between numpy arrays and the port's tensors.

Model parameter trees are nested dicts, so the path string "layers/attn/wq"
reconstructs the tree exactly. Host arrays are numpy; bf16 host arrays are
tagged ``uint16`` bits (``repro_torch.device``) or, when they come from the
JAX package, ``ml_dtypes.bfloat16`` arrays recognised by dtype name.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import as_bf16_bits, is_bf16, tensor_from_numpy, tensor_to_numpy


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """Flatten a params tree to host numpy arrays (the publishing side of
    the bridge: tensors come back through ``.cpu()``, bf16 as tagged uint16
    bits, so the ``.trims`` header says ``"bfloat16"``)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else k, node[k])
        elif torch.is_tensor(node):
            flat[prefix] = tensor_to_numpy(node)
        else:
            a = np.asarray(node)
            flat[prefix] = as_bf16_bits(a) if is_bf16(a) else a

    walk("", params)
    return flat


def flat_to_params(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return root


def flat_to_params_like(template, flat: Dict[str, Any], convert=None):
    """Rebuild into ``template``'s exact structure (keeps empty subtrees —
    e.g. non-parametric norms — that a bare unflatten would drop)."""
    convert = convert or (lambda x: x)

    def fill(prefix, node):
        if isinstance(node, dict):
            return {k: fill(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if prefix not in flat:
            raise KeyError(f"missing weight {prefix!r}")
        return convert(flat[prefix])

    return fill("", template)


def to_torch_tree(flat: Dict[str, np.ndarray], device="cuda", template: Optional[dict] = None):
    """The weight bridge: flat numpy params (the JAX package's
    ``params_to_flat`` output, or a ``.trims`` read) -> the port's params
    tree of tensors on ``device``, byte for byte. With ``template`` (e.g.
    ``init_params(cfg, device="meta")``) the tree keeps empty subtrees.
    :func:`params_to_flat` is the inverse."""
    if template is not None:
        return flat_to_params_like(template, flat,
                                   convert=lambda a: tensor_from_numpy(a, device))
    return flat_to_params({n: tensor_from_numpy(a, device) for n, a in flat.items()})
