"""In-step collectives over a process group.

Counterpart of ``chainermn_tpu/ops/collective.py``: the plain collectives
(``psum``, ``pmean``, ``pmax``, ``pmin``, ``pmean_if_bound``,
``all_gather``, ``all_to_all``, ``reduce_scatter``, ``ppermute``,
``shift``, ``axis_index``, ``axis_size``, ``bcast``), the block-scaled
int8 ring (``quantized_ring_pmean``, its quantizer ``block_quantize`` /
``block_dequantize``), the two-tier ``hierarchical_pmean``, and copies of
the cost model (``collective_wire_cost``, ``quantized_ring_cost``,
``quantized_ring_static_groups``, ``choose_pipeline_depth``,
``LEDGER_TO_PRIMITIVE``).  JAX calls them inside one SPMD program where
``axis_name`` is bound; here each rank is a process that calls them
eagerly on its own tensor.  ``axis_name`` names an axis of the N-D mesh
bound by ``with mesh:`` (:func:`~chainermn_tpu_torch.topology.make_nd_mesh`;
the collective runs over this rank's group along that axis), or else the
group of :func:`~chainermn_tpu_torch.topology.make_mesh` (the world), or is
a :class:`~chainermn_tpu_torch.topology.Mesh` whose group they run over.
Each returns this rank's block of JAX's result; none writes its input.

A gloo group has no card path for most collectives (its send / recv,
all-gather, reduce-scatter, all-to-all), so when the group's backend is
gloo a card tensor is staged through host memory: copied to the host, sent
and copied back.  The group's backend decides, before the call.

``psum`` / ``pmean`` / ``pmax`` / ``pmin`` / ``bcast`` also take a dict,
list or tuple of tensors, as JAX's take a pytree.  ``ppermute`` and
``shift`` post every send and receive of the permutation as one
``batch_isend_irecv`` (a ring of blocking sends deadlocks on NCCL); a
pair from a rank to itself is a copy.  They are not differentiable: the
``torch.autograd.Function`` forms are in ``functions/``.

Every public collective goes through the comm ledger
(:func:`chainermn_tpu_torch.observability.comm.collective`): with tracing
enabled it books op, axis, payload bytes, wire dtype and host latency per
call (a composite such as ``shift`` or the int8 ring books once, under its
own name), and with a collective guard of :mod:`chainermn_tpu_torch.health`
installed, a call that does not complete within the guard's window aborts
loudly naming the lost rank(s).  With tracing off and no guard the wrapper
costs an attribute read and a global read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..observability.comm import collective as _acc
from ..topology import DEFAULT_AXIS_NAME, Mesh, bound_axis, make_mesh

# torch 2.13 flags reduce_scatter_tensor as deprecated in favour of
# reduce_scatter_single; older torch has only the former
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


#: Ledger op -> the collective primitive its wire leg is: the JAX
#: package's join key between its comm ledger and its traced program,
#: copied for the cost model.  ``None`` marks the quantized ring, a
#: composite whose cost is :func:`quantized_ring_cost`.
LEDGER_TO_PRIMITIVE = {
    "psum": "psum",
    "pmean": "psum",
    "pmax": "pmax",
    "pmin": "pmin",
    "pmean_if_bound": "psum",
    "all_gather": "all_gather",
    "all_to_all": "all_to_all",
    "reduce_scatter": "psum_scatter",
    "ppermute": "ppermute",
    "shift": "ppermute",
    "bcast": "all_gather",
    "hierarchical_pmean": "psum",
    "quantized_ring_pmean": None,
    "grad_allreduce_ad": "psum",
}


def collective_wire_cost(primitive: str, payload_bytes: int,
                         axis_size: int) -> dict:
    """Physical wire cost of ONE collective on a ring schedule:
    ``{"wire_bytes": per-rank bytes on the wire, "messages": per-rank
    message count}``.  ``payload_bytes`` is the call's input payload; an
    all-reduce is reduce-scatter + all-gather, each moving ``(P-1)/P`` of
    the payload over ``P-1`` hops.  At axis size 1 everything is free."""
    p = int(axis_size)
    if p <= 1:
        return {"wire_bytes": 0, "messages": 0}
    b = int(payload_bytes)
    if primitive in ("psum", "pmax", "pmin"):            # all-reduce
        return {"wire_bytes": 2 * b * (p - 1) // p, "messages": 2 * (p - 1)}
    if primitive in ("psum_scatter", "reduce_scatter"):  # reduce-scatter
        return {"wire_bytes": b * (p - 1) // p, "messages": p - 1}
    if primitive == "all_gather":   # payload = the PER-RANK input block
        return {"wire_bytes": b * (p - 1), "messages": p - 1}
    if primitive == "all_to_all":
        return {"wire_bytes": b * (p - 1) // p, "messages": p - 1}
    if primitive in ("ppermute", "pshuffle"):
        return {"wire_bytes": b, "messages": 1}
    return {"wire_bytes": b, "messages": 1}  # unknown: conservative


def _mesh(axis_name) -> Mesh:
    if isinstance(axis_name, Mesh):
        return axis_name
    return bound_axis(axis_name) or make_mesh(axis_name)


def host_staged(mesh: Mesh, x) -> bool:
    """Whether ``x`` goes through host memory on ``mesh``'s group: a card
    tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _staged(mesh: Mesh, x):
    """``(x or its host copy, the device to return to)``."""
    return (x.cpu(), x.device) if host_staged(mesh, x) else (x, x.device)


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _all_reduce(x, op, mesh):
    out, dev = _staged(mesh, x.detach())
    out = out.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out.to(dev)


def psum(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _acc("psum", mesh, x, lambda: _tree_map(
        lambda v: _all_reduce(v, dist.ReduceOp.SUM, mesh), x))


def pmean(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _acc("pmean", mesh, x, lambda: _tree_map(
        lambda v: _all_reduce(v, dist.ReduceOp.SUM, mesh) / mesh.size, x))


def pmax(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _acc("pmax", mesh, x, lambda: _tree_map(
        lambda v: _all_reduce(v, dist.ReduceOp.MAX, mesh), x))


def pmin(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _acc("pmin", mesh, x, lambda: _tree_map(
        lambda v: _all_reduce(v, dist.ReduceOp.MIN, mesh), x))


def pmean_if_bound(x, axis_name: Optional[str] = DEFAULT_AXIS_NAME):
    """The cross-rank mean when there is a process group to mean over;
    identity otherwise (JAX: when ``axis_name`` is not bound)."""
    if axis_name is None or not dist.is_initialized():
        return x
    return pmean(x, axis_name)


def all_gather(x, axis_name=DEFAULT_AXIS_NAME, axis: int = 0,
               tiled: bool = True):
    """Every rank's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new axis ``axis``."""
    mesh = _mesh(axis_name)

    def run():
        v, dev = _staged(mesh, x.detach().contiguous())
        parts = [torch.empty_like(v) for _ in range(mesh.size)]
        dist.all_gather(parts, v, group=mesh.group)
        parts = [p.to(dev) for p in parts]     # join on the caller's device
        return (torch.cat(parts, dim=axis) if tiled
                else torch.stack(parts, axis))

    return _acc("all_gather", mesh, x, run)


def all_to_all(x, axis_name=DEFAULT_AXIS_NAME, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True):
    """Chunk ``j`` of ``x`` along ``split_axis`` goes to rank ``j``; the
    chunks received are joined along ``concat_axis`` in rank order.
    Untiled, ``split_axis`` has the group's size, each chunk is one index
    of it (the axis removed) and the chunks stack on a new axis
    ``concat_axis``."""
    mesh = _mesh(axis_name)
    return _acc("all_to_all", mesh, x, lambda: _all_to_all(
        x, mesh, split_axis, concat_axis, tiled))


def _all_to_all(x, mesh, split_axis, concat_axis, tiled):
    if tiled:
        chunks = x.detach().chunk(mesh.size, dim=split_axis)
    else:
        chunks = x.detach().unbind(split_axis)
    if len(chunks) != mesh.size or x.shape[split_axis] % mesh.size:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split into {mesh.size} equal chunks")
    send, dev = _staged(mesh, torch.stack(chunks).contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    parts = recv.to(dev).unbind(0)         # join on the caller's device
    return torch.cat(parts, dim=concat_axis) if tiled \
        else torch.stack(parts, dim=concat_axis)


def reduce_scatter(x, axis_name=DEFAULT_AXIS_NAME, scatter_axis: int = 0):
    """The cross-rank sum of ``x``, of which this rank keeps block
    ``rank`` along ``scatter_axis``."""
    mesh = _mesh(axis_name)
    return _acc("reduce_scatter", mesh, x,
                lambda: _reduce_scatter_one(x, mesh, scatter_axis))


def _reduce_scatter_one(x, mesh, scatter_axis):
    if x.shape[scatter_axis] % mesh.size:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not "
                         f"divide by {mesh.size}")
    inp, dev = _staged(mesh, x.detach().movedim(scatter_axis, 0)
                       .contiguous())
    out = inp.new_empty((inp.shape[0] // mesh.size,) + inp.shape[1:])
    _reduce_scatter(out, inp, group=mesh.group)
    return out.movedim(0, scatter_axis).to(dev)


def ppermute(x, perm, axis_name=DEFAULT_AXIS_NAME):
    """``perm`` is a list of ``(source, dest)`` rank pairs: rank ``dest``
    gets ``source``'s ``x``; a rank no pair sends to gets zeros."""
    mesh = _mesh(axis_name)
    return _acc("ppermute", mesh, x, lambda: _ppermute(x, perm, mesh))


def _ppermute(x, perm, mesh):
    me = dist.get_rank(mesh.group)
    x, dev = _staged(mesh, x.detach().contiguous())
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, _peer(mesh, dst),
                                  mesh.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _peer(mesh, src),
                                  mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(dev)


def _peer(mesh, r):
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def shift(x, offset: int, axis_name=DEFAULT_AXIS_NAME,
          size: Optional[int] = None):
    """Ring shift by ``offset``: rank ``i``'s ``x`` lands on rank
    ``(i + offset) % size``."""
    mesh = _mesh(axis_name)
    if size is None:
        size = mesh.size
    perm = [(i, (i + offset) % size) for i in range(size)]
    return _acc("shift", mesh, x, lambda: _ppermute(x, perm, mesh))


def axis_index(axis_name=DEFAULT_AXIS_NAME) -> int:
    return dist.get_rank(_mesh(axis_name).group)


def axis_size(axis_name=DEFAULT_AXIS_NAME) -> int:
    return _mesh(axis_name).size


def bcast(x, root: int = 0, axis_name=DEFAULT_AXIS_NAME):
    """Every rank gets rank ``root``'s block."""
    mesh = _mesh(axis_name)

    def one(v):
        out, dev = _staged(mesh, v.detach())
        out = out.clone()
        dist.broadcast(out, src=_peer(mesh, root), group=mesh.group)
        return out.to(dev)

    return _acc("bcast", mesh, x, lambda: _tree_map(one, x))


#: One fp32 scale per this many elements: the per-block error is at most
#: ``blockmax/254`` (int8), and the scales are 4 bytes per 256 of payload.
DEFAULT_QUANT_BLOCK = 256


def _ring_layout(n_elements: int, axis_size: int, block: int,
                 pipeline: int):
    """``(chunk_len, eff_block, nb_sub, k)``: the one layout that the ring
    and its cost model share.  Each rank owns a chunk of ``chunk_len = k
    · nb_sub · eff_block`` elements (``n`` padded up to ``p ·
    chunk_len``): ``k`` pipeline sub-chunks of ``nb_sub`` quantization
    blocks each; ``eff_block`` shrinks to the raw chunk for a small
    leaf."""
    p = max(1, int(axis_size))
    raw = -(-max(1, int(n_elements)) // p)       # ceil(n / p)
    eff_block = max(1, min(int(block), raw))
    k = max(1, int(pipeline))
    nb_sub = -(-raw // (k * eff_block))          # blocks per sub-chunk
    return k * nb_sub * eff_block, eff_block, nb_sub, k


def _dtype(d) -> torch.dtype:
    """A torch dtype from its torch, numpy or string spelling."""
    if isinstance(d, torch.dtype):
        return d
    try:
        name = np.dtype(d).name
    except TypeError:
        name = str(d)
    dt = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"not a dtype: {d!r}")
    return dt


def _int_wire(wire_dtype) -> torch.dtype:
    wire = _dtype(wire_dtype)
    if wire.is_floating_point or wire.is_complex or wire == torch.bool:
        raise ValueError(f"wire_dtype must be an integer type, got "
                         f"{str(wire).replace('torch.', '')}")
    return wire


def quantized_ring_cost(n_elements: int, axis_size: int, wire_dtype="int8",
                        block: int = DEFAULT_QUANT_BLOCK,
                        pipeline: int = 1) -> dict:
    """Wire cost of :func:`quantized_ring_pmean` per rank: ``{
    "ledger_bytes"`` (``n`` times the wire's item size), ``"wire_bytes"``
    (the reduce-scatter hops' and the gather ring's payload),
    ``"scale_bytes"`` (the in-band fp32 block scales of both phases),
    ``"messages"`` (``k`` a hop over ``P-1`` hops, then ``P-1`` for the
    gather)``}``."""
    p = int(axis_size)
    item = _dtype(wire_dtype).itemsize
    n = int(n_elements)
    if p <= 1:
        return {"ledger_bytes": 0, "wire_bytes": 0, "scale_bytes": 0,
                "messages": 0}
    chunk, _, nb_sub, k = _ring_layout(n, p, block, pipeline)
    nb = k * nb_sub                              # scale blocks per chunk
    rs_bytes = (p - 1) * chunk * item            # k packed msgs per hop
    ag_bytes = (p - 1) * chunk * item            # tiled all_gather ring
    scales = 2 * (p - 1) * nb * 4                # in-band, both phases
    return {"ledger_bytes": n * item, "wire_bytes": rs_bytes + ag_bytes,
            "scale_bytes": scales, "messages": k * (p - 1) + (p - 1)}


def quantized_ring_static_groups(n_elements: int, axis_size: int,
                                 axis_name: str = DEFAULT_AXIS_NAME,
                                 wire_dtype="int8",
                                 block: int = DEFAULT_QUANT_BLOCK,
                                 pipeline: int = 1) -> dict:
    """The ring's collectives as ``primitive@axis -> payload bytes``
    groups (the payload of each call is its input, scales included)."""
    p = int(axis_size)
    if p <= 1:
        return {}
    item = _dtype(wire_dtype).itemsize
    chunk, _, nb_sub, k = _ring_layout(n_elements, p, block, pipeline)
    nb = k * nb_sub
    return {f"ppermute@{axis_name}": (p - 1) * (chunk * item + nb * 4),
            f"all_gather@{axis_name}": chunk * item + nb * 4}


def choose_pipeline_depth(chunk_bytes: int, bw_bytes_per_s: float = 1.8e11,
                          alpha_s: float = 1e-6,
                          dequant_bytes_per_s: float = 4e11,
                          candidates=(1, 2, 4, 8)) -> int:
    """The ring's pipeline depth ``k`` from a per-hop cost model: a hop of
    ``k`` sub-chunks costs ``k·alpha + max(T, D) + min(T, D)/k``, ``T``
    the chunk's transfer and ``D`` its dequant + accumulate (the JAX
    package's defaults: a TPU v5e link, not measured here)."""
    chunk_bytes = max(0, int(chunk_bytes))
    t = chunk_bytes / float(bw_bytes_per_s)
    d = chunk_bytes / float(dequant_bytes_per_s)

    def hop_cost(k):
        return k * float(alpha_s) + max(t, d) + min(t, d) / k

    return min(candidates, key=hop_cost)


def _quant_rows(vb, wire, qmax):
    """Per-row (block) symmetric quantization of ``vb`` (..., B): ``q =
    round(v / scale)`` (half to even) clipped to ``±qmax``, ``scale =
    max(blockmax, 1e-30) · (1/qmax)``.  The reciprocal is what XLA makes
    of the division by the constant ``qmax`` in JAX's compiled ring."""
    scale = vb.abs().amax(-1).clamp_min(1e-30) * (1.0 / qmax)
    q = torch.round(vb / scale.unsqueeze(-1)).clamp_(-qmax, qmax).to(wire)
    return q, scale


def block_quantize(v, wire_dtype="int8", block: int = DEFAULT_QUANT_BLOCK):
    """``(q, scales)``: ``v`` flattened, zero-padded to a multiple of the
    effective block (``min(block, n)``) and quantized per block with one
    fp32 scale each (:func:`_quant_rows`): the error is at most
    ``blockmax/254`` a block for int8.  The ring's quantizer and the
    error-feedback residual's."""
    wire = _int_wire(wire_dtype)
    qmax = float(torch.iinfo(wire).max)
    flat = v.reshape(-1).float()
    n = flat.numel()
    eff = max(1, min(int(block), n))
    flat = torch.nn.functional.pad(flat, (0, (-n) % eff))
    return _quant_rows(flat.view(-1, eff), wire, qmax)


def block_dequantize(q, scales, shape=None, n_elements=None):
    """The inverse of :func:`block_quantize`: fp32 values cut to
    ``n_elements`` (or ``prod(shape)``) and reshaped to ``shape``."""
    flat = (q.float() * scales.unsqueeze(-1)).reshape(-1)
    if shape is not None and n_elements is None:
        n_elements = int(np.prod(shape)) if len(shape) else 1
    if n_elements is not None:
        flat = flat[:n_elements]
    return flat.reshape(shape) if shape is not None else flat


def _pack(q, scale, wire):
    """One message: the payload, then the fp32 scales' little-endian bytes
    as wire words (JAX's ``bitcast_convert_type``)."""
    return torch.cat([q.reshape(-1),
                      scale.contiguous().view(wire).reshape(-1)])


def _unpack(msg, nb, eff):
    q = msg[:nb * eff].view(nb, eff)
    return q, msg[nb * eff:].clone().view(torch.float32)


def _dequant_add(q, scale, acc):
    """``q · scale + acc`` rounded once, as the fused multiply-add that XLA
    compiles JAX's dequant-accumulate into: the int8 × fp32 product is
    exact in fp64, and so is nearly every sum (a double rounding needs an
    ``acc`` below 2^-29 of the product at an fp32 midpoint)."""
    return (q.double() * scale.double().unsqueeze(-1)
            + acc.double()).float()


def _ring_hop(msgs, mesh, me, p):
    """Each message to rank ``me + 1`` and one of the same size from rank
    ``me - 1``, all in one ``batch_isend_irecv`` (message ``j`` on tag
    ``j``), staged through host memory on a gloo group."""
    dev = msgs[0].device
    staged = host_staged(mesh, msgs[0])
    send = [m.cpu() if staged else m.contiguous() for m in msgs]
    recv = [torch.empty_like(m) for m in send]
    ops = []
    for j, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, _peer(mesh, (me + 1) % p),
                              mesh.group, tag=j))
        ops.append(dist.P2POp(dist.irecv, r, _peer(mesh, (me - 1) % p),
                              mesh.group, tag=j))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(dev) for r in recv]


def _ring_one(leaf, mesh, wire, qmax, block, pipeline):
    p = mesh.size
    me = dist.get_rank(mesh.group)
    flat = leaf.detach().reshape(-1).float()
    n = flat.numel()
    chunk_len, eff, nb_sub, k = _ring_layout(n, p, block, pipeline)
    chunks = torch.nn.functional.pad(flat, (0, p * chunk_len - n)).view(
        p, k, nb_sub, eff)
    # reduce-scatter: rank i starts by forwarding chunk i - 1, so hop s
    # carries the running sum of chunk i - 1 - s and rank i finishes its
    # own chunk i; each hop requantizes the running sum per block
    send = chunks[(me - 1) % p]
    for s in range(p - 1):
        q, scale = _quant_rows(send, wire, qmax)   # (k, nb_sub, B), (k, nb_sub)
        got = _ring_hop([_pack(q[j], scale[j], wire) for j in range(k)],
                        mesh, me, p)
        nxt = chunks[(me - s - 2) % p]
        send = torch.stack([_dequant_add(*_unpack(got[j], nb_sub, eff),
                                         nxt[j]) for j in range(k)])
    # gather: one quantization of the finished chunk, one tiled all-gather
    # of the packed message; rank r's row is chunk r
    nb = k * nb_sub
    q, scale = _quant_rows(send.reshape(nb, eff), wire, qmax)
    ga = all_gather(_pack(q, scale, wire), mesh, axis=0,
                    tiled=True).view(p, -1)
    gq = ga[:, :nb * eff].reshape(p, nb, eff)
    gs = ga[:, nb * eff:].contiguous().view(torch.float32)
    full = (gq.float() * gs.unsqueeze(-1)).reshape(-1)
    # XLA compiles JAX's division by the constant p to this product
    out = full[:n] * (1.0 / p)
    return out.reshape(leaf.shape).to(leaf.dtype)


def quantized_ring_pmean(x, axis_name=DEFAULT_AXIS_NAME, wire_dtype="int8",
                         block: int = DEFAULT_QUANT_BLOCK,
                         pipeline: int = 1):
    """The cross-rank mean with block-scaled ``wire_dtype`` (int8) hops:
    JAX's hand-scheduled ring, hop for hop.

    * Reduce-scatter over ``P-1`` hops: each carries the running sum of
      one chunk, requantized per block of ``block`` elements (one fp32
      scale each, shrunk to the chunk for a small leaf), as ``pipeline``
      sub-chunk messages (:func:`_ring_layout`), the scales in-band behind
      each payload; the receiver dequantizes and adds its own chunk.
    * Gather: the finished chunk quantized once more and one tiled
      all-gather of the packed message.

    Each leaf of ``x`` (a tensor, or a dict / list / tuple of them) is its
    own ring (:func:`~chainermn_tpu_torch.optimizers.compressed_mean`
    buckets a gradient list into one flat call); each comes back in its
    own dtype.  At one rank ``x`` itself is returned.  For gradients, not
    activations: the error compounds to about ``P/254`` of the leaf's
    largest entry."""
    mesh = _mesh(axis_name)
    if mesh.size == 1:
        return x
    wire = _int_wire(wire_dtype)
    qmax = float(torch.iinfo(wire).max)
    # booked at the WIRE dtype: about one byte an element (the fp32 block
    # scales are the cost model's scale_bytes), as JAX books it
    return _acc("quantized_ring_pmean", mesh, x, lambda: _tree_map(
        lambda v: _ring_one(v, mesh, wire, qmax, block, pipeline), x),
        wire_dtype=wire)


def _bound(axis_name):
    """The 1-D mesh of a bound axis name (or a Mesh); an unbound name
    raises ``NameError``, as JAX does outside its axis."""
    if isinstance(axis_name, Mesh):
        return axis_name
    mesh = bound_axis(axis_name)
    if mesh is None:
        raise NameError(f"unbound axis name {axis_name!r}: call inside "
                        f"`with mesh:` of a mesh that has it")
    return mesh


def hierarchical_pmean(x, chip_axis="chip", slice_axis="slice",
                       dcn_dtype=None):
    """The two-tier mean over a ``('slice', 'chip')`` mesh
    (:func:`~chainermn_tpu_torch.topology.make_multislice_mesh`): the mean
    over ``chip_axis`` (within a host), then over ``slice_axis`` (across
    hosts, once).  ``dcn_dtype`` (e.g. ``"bfloat16"``) casts only the
    slice leg.  Both axes must be bound (``with mesh:``) or be meshes."""
    chip, slc = _bound(chip_axis), _bound(slice_axis)

    def one(v):
        local = pmean(v, chip)
        if dcn_dtype is not None:
            return pmean(local.to(_dtype(dcn_dtype)), slc).to(v.dtype)
        return pmean(local, slc)

    return _acc("hierarchical_pmean", (chip, slc), x,
                lambda: _tree_map(one, x),
                wire_dtype=None if dcn_dtype is None else _dtype(dcn_dtype))


__all__ = ["DEFAULT_QUANT_BLOCK", "LEDGER_TO_PRIMITIVE", "all_gather",
           "all_to_all", "axis_index", "axis_size", "bcast",
           "block_dequantize", "block_quantize", "choose_pipeline_depth",
           "collective_wire_cost", "hierarchical_pmean", "host_staged",
           "pmax", "pmean", "pmean_if_bound", "pmin", "ppermute", "psum",
           "quantized_ring_cost", "quantized_ring_pmean",
           "quantized_ring_static_groups", "reduce_scatter", "shift"]
