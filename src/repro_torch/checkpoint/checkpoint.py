"""Checkpoints in the ``.trims`` container of ``core/store``, the format the
MRM serves, so a training checkpoint is loadable by the serving tier.

A copy of the JAX package's ``checkpoint/checkpoint.py``: the same tree
paths (``_flatten``/``_unflatten``), the same layout, and files that either
package restores byte for byte::

  <dir>/step_000123/state.trims   tensors named by tree path
  <dir>/step_000123/META.json     step, timestamp, meta
  <dir>/LATEST                    the newest step dir's name

Leaves are tensors (copied to the host with ``tensor_to_numpy``; bf16 as
tagged ``uint16`` bits, written as ``"bfloat16"``) or host arrays. A
``DTensor`` leaf is gathered whole first (a collective: every rank of its
mesh calls the save; the manager writes on rank 0 only), so a checkpoint
holds full tensors and is byte-equal whatever mesh saved it.
:func:`restore_into` puts a leaf on a device, or, given ``shardings``
(``launch.sharding.NamedSharding``s), re-shards it onto the mesh in use,
which may differ from the mesh that saved it.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.store import ModelFile, write_model
from repro_torch.device import is_distributed, tensor_from_numpy, tensor_to_numpy

SEP = "/"


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                walk(f"{prefix}{SEP}#{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split(SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [fix(node[f"#{i}"]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def to_host(leaf) -> np.ndarray:
    """A host copy of a tensor (a DTensor gathered whole), or the host
    array as it is."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    if is_distributed(leaf):
        leaf = leaf.full_tensor()
    return tensor_to_numpy(leaf)


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    meta: Optional[dict] = None) -> str:
    """state: {"params": tree, "opt_mu": tree, "opt_nu": tree, "opt_step": 0-d int32}."""
    host = {k: to_host(v) for k, v in _flatten(state).items()}
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    write_model(os.path.join(tmp, "state.trims"), host,
                meta={"step": step, **(meta or {})})
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(d))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _read(ckpt_dir: str, step: Optional[int]) -> Tuple[int, Dict[str, np.ndarray]]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    mf = ModelFile(os.path.join(ckpt_dir, f"step_{step:08d}", "state.trims"))
    return step, mf.read_all()


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None
                       ) -> Tuple[int, Dict[str, Any]]:
    """(step, state tree of host arrays); the newest step by default."""
    step, flat = _read(ckpt_dir, step)
    return step, _unflatten(flat)


def restore_into(template, ckpt_dir: str, step: Optional[int] = None,
                 device=None, shardings=None) -> Tuple[int, Any]:
    """Restore leaves into ``template``'s exact structure (keeping empty
    subtrees, e.g. non-parametric norms, which a bare unflatten drops), as
    tensors on ``device`` (default: each template leaf's own; a ``"meta"``
    template needs one). ``shardings``, a tree like the template's of
    ``launch.sharding.NamedSharding`` (None leaves stay whole), re-shards
    each leaf onto its mesh: every rank reads the full leaf and keeps its
    shard, as the reference's ``device_put`` does from host arrays."""
    step, flat = _read(ckpt_dir, step)
    flat_sh = _flatten(shardings) if shardings is not None else {}

    def fill(prefix, node):
        if isinstance(node, dict):
            return {k: fill(f"{prefix}{SEP}{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(fill(f"{prefix}{SEP}#{i}", v) for i, v in enumerate(node))
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = flat.pop(prefix)      # the host copy goes once its tensor is made
        t = tensor_from_numpy(arr, device if device is not None else node.device)
        sh = flat_sh.get(prefix)
        if sh is None:
            return t
        from repro_torch.launch.sharding import place
        return place(t, sh)

    return step, fill("", template)


def retain(ckpt_dir: str, keep: int = 3):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
