"""Parameter conversion: the JAX package's LM params → the port's, and npz files.

:func:`from_jax` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, init_tp_transformer_lm(...))`` gives
(numpy's ``bfloat16`` from ``ml_dtypes`` included) and returns the same
structure of torch tensors, so both packages compute the same function.
:func:`to_numpy` goes back to fp32 numpy arrays.
:func:`shard_from_jax` cuts the global params to this rank's shards of a
tensor-parallel mesh, and :func:`gather_to_numpy` gathers them back.
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


def shard_from_jax(params, specs, mesh, device="cuda", dtype=None):
    """GLOBAL params (the JAX package's numpy tree, or the port's tensors)
    → this rank's shards on ``device``: each leaf cut by its spec
    (``parallel.transformer_lm_specs`` or ``tensor_parallel.tp_mlp_specs``)
    at this rank's coordinates of ``mesh`` (``topology.make_nd_mesh``).  A
    contiguous ``1/P`` of the head-major ``wqkv`` / ``wkv`` columns is a
    whole set of heads, so the cut follows heads as JAX's sharding does."""
    from .parallel.hybrid import shard_pytree

    dev = resolve_device(device)
    host = shard_pytree(tree_map(params, lambda a: a.detach() if isinstance(
        a, torch.Tensor) else _to_tensor(a)), mesh, specs)
    return tree_map(host, lambda t: t.to(device=dev, dtype=dtype or t.dtype))


def gather_to_numpy(params, specs, mesh) -> Dict[str, Any]:
    """Inverse of :func:`shard_from_jax`: every rank's shards gathered over
    the mesh axes of their specs, as fp32 numpy.  Every rank of ``mesh``
    must call it."""
    from .parallel._factory import _zip_map, gather_block

    return to_numpy(_zip_map(
        lambda t, s: gather_block(t.detach(), s, mesh), params, specs))


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
    parts = key.rsplit(".", 2)
    return len(parts) > 1 and parts[-2].startswith("Dense_") and (
        key.endswith(".kernel") or key.endswith(".weight"))


def resnet_from_jax(variables, model):
    """Load flax ``{"params", "batch_stats"}`` (arrays as numpy) into the
    port's :class:`~chainermn_tpu_torch.models.resnet.ResNet` in place and
    return it.  Conv kernels stay HWIO, ``Dense`` kernels (in, out) become
    ``Linear`` weights (out, in), norm ``scale``/``bias`` go to the
    parameters and the statistics (``mean``/``var``, ``last_mean``/
    ``last_var``) to the buffers.  Every tensor of the module must be
    covered, and every array must find its tensor.

    The mapping is by flax's names, which every ImageNet model of the port
    keeps, so the same function loads the NF-ResNets, the convnets and ViT
    (:func:`nf_resnet_from_jax`, :func:`convnet_from_jax`,
    :func:`vit_from_jax`: ``ScaledWSConv`` kernels and gains, ``skip_gain``,
    conv biases, ``qkv`` / ``proj`` in flax's layouts, ``pos_embed``,
    ``cls``)."""
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


nf_resnet_to_numpy = convnet_to_numpy = vit_to_numpy = resnet_to_numpy


nf_resnet_from_jax = convnet_from_jax = vit_from_jax = resnet_from_jax


def mlp_from_jax(params, model):
    """Load flax ``MLP`` params (``{"Dense_i": {"kernel", "bias"}}`` as
    numpy, or ``{"params": ...}`` around them) into the port's
    :class:`~chainermn_tpu_torch.models.mlp.MLP` in place and return it:
    each (in, out) kernel becomes ``nn.Linear.weight`` (out, in)."""
    if "params" in params:
        params = params["params"]
    return resnet_from_jax({"params": params}, model)


def demo_params_from_numpy(params, device="cuda") -> Dict[str, Any]:
    """The demo step's ``{"w1", "b1", "w2", "b2"}`` numpy arrays (the JAX
    CLI's layout: ``x @ w1 + b1``) as fp32 leaf tensors on ``device`` that
    require gradients."""
    dev = resolve_device(device)
    return {k: _to_tensor(params[k]).to(dev, torch.float32)
            .requires_grad_(True) for k in ("w1", "b1", "w2", "b2")}


_GATES = ("i", "f", "g", "o")


def seq2seq_from_jax(params, model):
    """Load flax ``Seq2seq`` params (``{"params": ...}`` or the tree inside,
    arrays as numpy) into the port's
    :class:`~chainermn_tpu_torch.models.seq2seq.Seq2seq` in place and
    return it.  Each layer's four input kernels ``ii … io`` (in, H) become
    ``wi`` (4H, in), its hidden kernels ``hi … ho`` ``wh`` (4H, H) and their
    biases ``bh``; ``proj.kernel`` (U, V) becomes ``proj.weight`` (V, U)."""
    if "params" in params:
        params = params["params"]
    np32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    src = {f"{e}.embedding": np32(params[e]["embedding"])
           for e in ("embed_x", "embed_y")}
    src["proj.weight"] = np32(params["proj"]["kernel"]).T
    src["proj.bias"] = np32(params["proj"]["bias"])
    for stack in ("encoder", "decoder"):
        for i in range(model.n_layers):
            cell = params[stack][f"lstm{i}"]
            key = f"{stack}.lstm{i}"
            src[f"{key}.wi"] = np.concatenate(
                [np32(cell[f"i{g}"]["kernel"]) for g in _GATES], -1).T
            src[f"{key}.wh"] = np.concatenate(
                [np32(cell[f"h{g}"]["kernel"]) for g in _GATES], -1).T
            src[f"{key}.bh"] = np.concatenate(
                [np32(cell[f"h{g}"]["bias"]) for g in _GATES])
    targets = dict(model.named_parameters())
    if set(targets) != set(src):
        raise KeyError(f"tensors without a JAX array: "
                       f"{sorted(set(targets) - set(src))}; arrays without "
                       f"a tensor: {sorted(set(src) - set(targets))}")
    with torch.no_grad():
        for key, a in src.items():
            dst = targets[key]
            if tuple(dst.shape) != a.shape:
                raise ValueError(f"{key}: JAX shape {a.shape}, module shape "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(a)))
    return model
