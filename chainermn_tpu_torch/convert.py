"""Parameter conversion: the JAX package's LM params → the port's, and npz files.

:func:`from_jax` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, init_tp_transformer_lm(...))`` gives
(numpy's ``bfloat16`` from ``ml_dtypes`` included) and returns the same
structure of torch tensors, so both packages compute the same function.
:func:`to_numpy` goes back to fp32 numpy arrays.
:func:`save_npz` / :func:`load_npz` store the structure under flat keys
such as ``blocks.0.attn.wqkv`` (``serve.py --params``).  Neither needs
JAX: a JAX-side caller converts with ``np.asarray`` first.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from ._device import resolve_device

_META_KEY = "__dtypes__"


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tree_map(tree, fn):
    """``fn`` over every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def from_jax(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """Numpy (or array-like) param tree → torch tensors on ``device``,
    optionally cast to ``dtype``."""
    dev = resolve_device(device)

    def conv(a):
        t = _to_tensor(a)
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(tree, conv)


def to_numpy(params) -> Dict[str, Any]:
    """Torch param tree → the same structure of fp32 numpy arrays on the
    host (detached), for comparing with the JAX package's params."""
    return tree_map(params, lambda t: t.detach().float().cpu().numpy())


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested params → ``{"blocks.0.attn.wqkv": leaf, ...}``."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten`; integer key parts become list indices."""
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_npz(path: str, params) -> None:
    """Write params (torch tensors or numpy arrays) under flat keys; bf16
    leaves are stored as fp32 (exact) and restored from the dtype table."""
    arrays, dtypes = {}, {}
    for key, leaf in flatten(params).items():
        if isinstance(leaf, torch.Tensor):
            dtypes[key] = str(leaf.dtype).replace("torch.", "")
            leaf = leaf.detach().cpu()
            arrays[key] = (leaf.float() if leaf.dtype == torch.bfloat16
                           else leaf).numpy()
        else:
            a = np.asarray(leaf)
            dtypes[key] = a.dtype.name
            arrays[key] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    arrays[_META_KEY] = np.array(json.dumps(dtypes))
    np.savez(path, **arrays)


def load_npz(path: str, device="cuda", dtype=None) -> Dict[str, Any]:
    """Read a :func:`save_npz` file back into nested torch params on
    ``device`` (cast to ``dtype`` when given)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z[_META_KEY]))
        flat = {}
        for key in z.files:
            if key == _META_KEY:
                continue
            t = torch.from_numpy(z[key].copy())
            want = dtype or (getattr(torch, dtypes[key]) if key in dtypes
                             else t.dtype)
            flat[key] = t.to(device=dev, dtype=want)
    return unflatten(flat)


def _flat_items(tree, prefix=""):
    """``{"a.b.c": leaf}`` of a nested mapping (dict or flax FrozenDict)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat_items(v, key) if hasattr(v, "items") else {key: v})
    return out


def _nest(flat):
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        *parts, last = key.split(".")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return root


def _dense(key):
    """The ``Dense`` (in, out) kernels; torch's ``Linear`` holds (out, in)."""
    return key.rsplit(".", 2)[-2].startswith("Dense_") and (
        key.endswith(".kernel") or key.endswith(".weight"))


def resnet_from_jax(variables, model):
    """Load flax ``{"params", "batch_stats"}`` (arrays as numpy) into the
    port's :class:`~chainermn_tpu_torch.models.resnet.ResNet` in place and
    return it.  Conv kernels stay HWIO, ``Dense`` kernels (in, out) become
    ``Linear`` weights (out, in), BatchNorm ``scale``/``bias`` go to the
    parameters and ``mean``/``var`` to the buffers.  Every tensor of the
    module must be covered, and every array must find its tensor."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    src = _flat_items(variables["params"])
    src.update(_flat_items(variables.get("batch_stats", {})))
    missing = set(targets) - {k.replace(".kernel", ".weight") if _dense(k)
                              else k for k in src}
    if missing:
        raise KeyError(f"no JAX array for {sorted(missing)}")
    with torch.no_grad():
        for key, a in src.items():
            t = _to_tensor(a)
            if _dense(key):
                key, t = key.replace(".kernel", ".weight"), t.t()
            if key not in targets:
                raise KeyError(f"the module has no tensor for JAX's {key}")
            dst = targets[key]
            if tuple(dst.shape) != tuple(t.shape):
                raise ValueError(f"{key}: JAX shape {tuple(t.shape)}, module "
                                 f"shape {tuple(dst.shape)}")
            dst.copy_(t.to(dst.dtype))
    return model


def resnet_to_numpy(model) -> Dict[str, Any]:
    """The module as flax's ``{"params": ..., "batch_stats": ...}`` of fp32
    numpy arrays (``Linear`` weights back to (in, out) kernels), for
    comparing with the JAX package key by key."""
    def host(t, key):
        a = t.detach().float().cpu().numpy()
        return (key.replace(".weight", ".kernel"), a.T) if _dense(key) \
            else (key, a)

    params = dict(host(t, k) for k, t in model.named_parameters())
    stats = dict(host(t, k) for k, t in model.named_buffers())
    return {"params": _nest(params), "batch_stats": _nest(stats)}
