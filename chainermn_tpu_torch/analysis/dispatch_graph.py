"""Dispatch graph: one recorded call of a function, as a graph of nodes.

The port's counterpart of a jaxpr for the shard-flow analyzer
(``analysis/shardflow.py``).  Eager torch builds no program; what it runs
is seen at the dispatcher, so :class:`GraphRecorder` opens a
``TorchDispatchMode`` around ONE call and writes every op that reaches it
as a node: its op name, the values it reads and the values it writes.

* **A value is a storage**, not a tensor: a view (``view``, ``detach``,
  ``permute``, a slice) reads its base's storage and defines nothing, and
  an in-place op (``add_``, ``copy_``, an optimizer's ``_foreach_*_``)
  writes the storage it mutates (its schema's ``(a!)`` arguments) and
  defines nothing new.  A value is first seen either as the new storage
  of an op's result (defined in the graph) or as the storage of an
  argument (an input of the graph: it existed before the call).  Storages
  are tracked through weak references, so the recording holds nothing
  alive and a storage freed and reallocated at the same address is a new
  value.
* **The accounted collective face** (``observability.comm.collective``,
  which ``accounted_method`` runs through) is one node, with its ledger
  op, axes, axis size, ``noted`` flag and ledger payload, whatever it runs
  inside.  Its inner aten ops are hidden: what they read outside the node
  is its input, what they write outside it is its output, and what they
  allocate and drop is not in the graph.  The raw ``c10d`` ops run inside
  are kept on the node as its *wire legs* (op, bytes, dtype); a nested
  accounted call (the int8 ring's gather, ``hierarchical_pmean``'s two
  means) is a child node with legs of its own.  A raw ``c10d`` op outside
  every accounted node is a top-level ``c10d`` node: a collective that
  bypasses the accounted face.
* **A kernel wrapper of** ``ops/`` (the ``dispatch`` decorator of
  ``ops/_dispatch.py``) is one node on both devices: it reads the
  tensors it is given and writes the tensors it returns, and everything
  it runs inside is hidden, the CUDA kernel on the card as the plain
  version on the CPU.  So the two devices give one graph at one size.

What the dispatch mode cannot see, and what stands in for it:

* a ctypes kernel's reads and writes: the wrapper node's arguments and
  results stand for them (an argument the kernel writes in place without
  returning it, as the decode kernel's append writes the K/V caches, is
  read by the node and not written);
* ``axis_index``: it returns a host int, so a tensor built from the rank
  (``arange(n) + rank``) is a plain constant here, not a rank-varying
  value; the AST engine covers rank-dependent control flow;
* a card tensor on a gloo group is staged through host memory: those
  copies are the accounted node's inner ops (memory, not wire);
* a rank's send to itself (``shift`` at one rank) posts no ``c10d`` op:
  the node has no wire leg, and its static payload still counts, as
  JAX's program holds the equation.

``backward`` on the card runs its ops on the autograd engine's device
thread; the dispatch mode is part of the thread-local state the engine
carries there, so they reach the graph.

Importing this module imports nothing beyond the standard library; torch
is imported when a recorder is built.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: c10d op name fragment -> (leg kind, index of the argument whose
#: tensors are the bytes the leg puts on the wire).  Matched against the
#: op the run records, so the names that vary with the torch version
#: (``_reduce_scatter_base_``, ``reduce_scatter_tensor_coalesced_``,
#: ``allgather_into_tensor_coalesced_``) fall in their kind.
_LEG_KINDS = (
    ("reduce_scatter", "reduce_scatter", 1),
    ("allreduce", "allreduce", 0),
    ("allgather", "allgather", 1),
    ("alltoall", "alltoall", 1),
    ("broadcast", "broadcast", 0),
    ("recv", "recv", 0),
    ("send", "send", 0),
    ("barrier", "barrier", None),
)


def _leg_kind(op_name: str) -> Tuple[str, Optional[int]]:
    for frag, kind, idx in _LEG_KINDS:
        if frag in op_name:
            return kind, idx
    return "other", 0


def _tensors(obj) -> List[Any]:
    """The tensors of an argument: a tensor, or lists / tuples / dicts of
    them, in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        out: List[Any] = []
        for v in obj:
            out.extend(_tensors(v))
        return out
    if isinstance(obj, dict):
        out = []
        for v in obj.values():
            out.extend(_tensors(v))
        return out
    return []


def _dtype_str(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _tensor_nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


@dataclass
class Value:
    """One storage seen by the recording."""

    vid: int
    nbytes: int
    device: str


@dataclass
class Leg:
    """One raw ``c10d`` op run inside an accounted node."""

    op: str                        # "c10d.allreduce_", ...
    kind: str                      # _LEG_KINDS kind
    nbytes: int                    # the bytes this rank puts in (or takes)
    dtype: str = "?"
    shape: Tuple[int, ...] = ()


@dataclass
class Node:
    """One op, accounted collective, kernel wrapper or raw c10d op."""

    kind: str                      # "aten" | "collective" | "kernel" | "c10d"
    name: str
    inputs: List[int] = field(default_factory=list)    # values read
    outputs: List[int] = field(default_factory=list)   # values written
    defs: List[int] = field(default_factory=list)      # values created
    shape: Tuple[int, ...] = ()    # first result tensor's
    dtype: str = "?"
    # accounted collectives only
    axes: Tuple[str, ...] = ()
    axis_size: int = 1
    noted: bool = False
    payload_bytes: int = 0         # the ledger's convention
    payload_dtype: str = "?"
    payload_shape: Tuple[int, ...] = ()
    legs: List[Leg] = field(default_factory=list)
    children: List["Node"] = field(default_factory=list)

    def all_legs(self) -> List[Leg]:
        """This node's legs and its descendants', in run order of nodes."""
        out = list(self.legs)
        for c in self.children:
            out.extend(c.all_legs())
        return out


@dataclass
class DispatchGraph:
    """The recorded call: top-level nodes in run order, every value, the
    graph's inputs (values read before any node defined them) and its
    outputs (the storages of the call's result)."""

    nodes: List[Node] = field(default_factory=list)
    values: Dict[int, Value] = field(default_factory=dict)
    inputs: List[int] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    #: storage key -> (weak reference, value id), shared with the recorder
    keys: Dict[Any, Tuple[Any, int]] = field(default_factory=dict,
                                             repr=False)

    def value_of(self, t) -> Optional[int]:
        """The value of tensor ``t``'s storage, if the recording saw it
        and it is still alive."""
        from torch.multiprocessing.reductions import StorageWeakRef

        try:
            hit = self.keys.get(StorageWeakRef(t.untyped_storage()).cdata)
        except (RuntimeError, NotImplementedError, TypeError):
            return None
        if hit is None or hit[0].expired():
            return None
        return hit[1]

    def nbytes(self, vid: int) -> int:
        v = self.values.get(vid)
        return v.nbytes if v is not None else 0

    def input_bytes(self, device_type: Optional[str] = None) -> int:
        """Bytes of the storages the call found resident and used (on
        ``device_type`` only, when given: ``"cuda"``, ``"cpu"``)."""
        return sum(self.nbytes(v) for v in self.inputs
                   if device_type is None
                   or self.values[v].device.split(":")[0] == device_type)

    def kernel_counts(self) -> Dict[str, int]:
        """Kernel-wrapper nodes by wrapper name."""
        out: Dict[str, int] = {}
        for n in self.walk():
            if n.kind == "kernel":
                out[n.name] = out.get(n.name, 0) + 1
        return out

    def walk(self):
        """Every node, children after their parent."""
        stack = list(reversed(self.nodes))
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(n.children))


class _Bracket:
    """An open accounted-collective node and what its inner ops touched."""

    def __init__(self, node: Node):
        self.node = node
        self.inside: set = set()   # values created inside
        self.reads: Dict[int, None] = {}
        self.writes: Dict[int, None] = {}


class GraphRecorder:
    """Record one call as a :class:`DispatchGraph`::

        rec = GraphRecorder()
        vid = rec.value_id(t)     # register a tensor that exists already
        with rec:
            out = fn(*args)
        graph = rec.finish(out)

    Opens the dispatch mode, the kernel-dispatch bracket
    (``ops._dispatch.dispatch_bracket``) and the collective bracket
    (``observability.comm.collective_bracket``); none of them nests."""

    def __init__(self):
        from torch.multiprocessing.reductions import StorageWeakRef

        self._weak = StorageWeakRef
        self.graph = DispatchGraph()
        self._by_key = self.graph.keys
        self._defined: set = set()
        self._stack: List[_Bracket] = []
        self._hidden = 0
        self._ctx: List[Any] = []

    # ---- values ----
    def _lookup(self, t) -> Tuple[Optional[int], bool]:
        """``(value id, created)`` of ``t``'s storage (None for a tensor
        with no storage bytes)."""
        try:
            st = t.untyped_storage()
            nbytes = int(st.nbytes())
        except (RuntimeError, NotImplementedError, TypeError):
            return None, False
        if nbytes == 0:
            return None, False
        ref = self._weak(st)
        hit = self._by_key.get(ref.cdata)
        if hit is not None and not hit[0].expired():
            return hit[1], False
        vid = len(self.graph.values)
        self.graph.values[vid] = Value(vid, nbytes, str(st.device))
        self._by_key[ref.cdata] = (ref, vid)
        return vid, True

    def value_id(self, t) -> Optional[int]:
        """The value of a tensor that exists before the call."""
        return self._lookup(t)[0]

    def _read_ids(self, objs, fresh: Optional[list] = None) -> List[int]:
        """Value ids of the tensors of ``objs``; ``fresh`` collects those
        seen for the first time."""
        out: Dict[int, None] = {}
        for t in _tensors(objs):
            vid, new = self._lookup(t)
            if vid is not None:
                out[vid] = None
                if new and fresh is not None:
                    fresh.append(vid)
        return list(out)

    def _result_ids(self, result) -> Tuple[List[int], List[int]]:
        """``(written existing values, created values)`` of a result."""
        written: Dict[int, None] = {}
        created: Dict[int, None] = {}
        for t in _tensors(result):
            vid, new = self._lookup(t)
            if vid is None:
                continue
            if new:
                created[vid] = None
            elif vid not in created:
                written[vid] = None
        return list(written), list(created)

    # ---- nodes ----
    def _emit(self, node: Node) -> None:
        if not self._stack:
            self._defined.update(node.defs)
            self.graph.nodes.append(node)
            return
        b = self._stack[-1]
        b.inside.update(node.defs)
        for v in node.inputs:
            if v not in b.inside:
                b.reads[v] = None
        for v in node.outputs:
            if v not in b.inside:
                b.writes[v] = None
        if node.kind == "collective":
            b.node.children.append(node)

    @staticmethod
    def _meta(result) -> Tuple[Tuple[int, ...], str]:
        ts = _tensors(result)
        if not ts:
            return (), "?"
        return tuple(int(s) for s in ts[0].shape), _dtype_str(ts[0])

    def _on_op(self, func, args, kwargs):
        if self._hidden:
            return func(*args, **kwargs)
        fresh: List[int] = []
        reads = self._read_ids((args, kwargs), fresh)
        mutated: List[Any] = []
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is not None and info.is_write:
                mutated.append(args[i] if i < len(args)
                               else kwargs.get(a.name))
        out = func(*args, **kwargs)
        # a result over an existing storage is a view (a read) unless the
        # schema says the op writes that argument
        _, created = self._result_ids(out)
        written = [v for v in self._read_ids(mutated) if v not in created]
        if self._stack:
            # a storage first seen as an argument inside an accounted
            # node was made there by an op the mode does not see (the
            # c10d implementation's own buffers): a temporary of the node
            created = fresh + created
        name = str(func)
        shape, dtype = self._meta(out)
        node = Node(kind="aten", name=name, inputs=reads,
                    outputs=written + created, defs=created, shape=shape,
                    dtype=dtype)
        if func.namespace == "c10d":
            kind, idx = _leg_kind(func.__name__)
            ts = _tensors(args[idx]) if idx is not None and idx < len(
                args) else []
            leg = Leg(op=f"c10d.{func.overloadpacket.__name__}", kind=kind,
                      nbytes=sum(_tensor_nbytes(t) for t in ts),
                      dtype=_dtype_str(ts[0]) if ts else "?",
                      shape=tuple(ts[0].shape) if ts else ())
            if self._stack:
                self._stack[-1].node.legs.append(leg)
            else:
                node.kind, node.name = "c10d", leg.op
                node.legs = [leg]
        self._emit(node)
        return out

    def _kernel_hook(self, name, fn, args, kwargs):
        if self._hidden:
            return fn(*args, **kwargs)
        reads = self._read_ids((args, kwargs))
        self._hidden += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._hidden -= 1
        written, created = self._result_ids(out)
        shape, dtype = self._meta(out)
        self._emit(Node(kind="kernel", name=name, inputs=reads,
                        outputs=written + created, defs=created,
                        shape=shape, dtype=dtype))
        return out

    def _collective_hook(self, op, axis, x, run, wire_dtype, noted):
        if self._hidden:
            return run()
        from ..observability import comm

        nbytes, dtype, n_elems, _ = comm.payload_info(x)
        if wire_dtype is not None:
            dtype = comm._dtype_name(wire_dtype)
            nbytes = n_elems * comm._itemsize(dtype)
        leaves = comm._leaves(x)
        first = next((leaf for leaf in leaves
                      if getattr(leaf, "shape", None) is not None), None)
        key = comm._axis_key(axis)
        node = Node(kind="collective", name=op,
                    axes=tuple(str(a) for a in key)
                    if isinstance(key, tuple) else (str(key),),
                    axis_size=_axis_size(axis), noted=bool(noted),
                    payload_bytes=int(nbytes), payload_dtype=dtype,
                    payload_shape=tuple(int(s) for s in first.shape)
                    if first is not None else ())
        reads = self._read_ids(leaves)
        b = _Bracket(node)
        self._stack.append(b)
        try:
            out = run()
        finally:
            self._stack.pop()
        written, created = self._result_ids(out)
        defs = created + [v for v in written if v in b.inside]
        written = [v for v in written if v not in b.inside]
        for v in b.reads:
            if v not in reads:
                reads.append(v)
        for v in b.writes:
            if v not in written:
                written.append(v)
        node.inputs, node.outputs, node.defs = reads, written + defs, defs
        node.shape, node.dtype = self._meta(out)
        self._emit(node)
        return out

    # ---- bracket ----
    def __enter__(self):
        from contextlib import ExitStack

        from torch.utils._python_dispatch import TorchDispatchMode

        from ..observability.comm import collective_bracket
        from ..ops._dispatch import dispatch_bracket

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return rec._on_op(func, args, kwargs or {})

        stack = ExitStack()
        try:
            stack.enter_context(dispatch_bracket(self._kernel_hook,
                                                 "dispatch graph"))
            stack.enter_context(collective_bracket(self._collective_hook,
                                                   "dispatch graph"))
            stack.enter_context(_Mode())
        except BaseException:
            stack.close()
            raise
        self._ctx.append(stack)
        return self

    def __exit__(self, *exc):
        self._ctx.pop().close()
        return False

    def finish(self, result=None) -> DispatchGraph:
        """Close the graph: ``result``'s storages are its outputs, and
        every value a node used before any node defined it is an input."""
        g = self.graph
        g.outputs = self._read_ids(result)
        used: Dict[int, None] = {}
        for n in g.nodes:
            for v in n.inputs + n.outputs:
                used[v] = None
        for v in g.outputs:
            used[v] = None
        g.inputs = sorted(v for v in used if v not in self._defined)
        return g


def _axis_size(axis) -> int:
    """The number of ranks of an accounted call's axis: a mesh's size, the
    product over a tuple of axes, a bound axis name's mesh, else the
    world."""
    if isinstance(axis, (tuple, list)):
        p = 1
        for a in axis:
            p *= _axis_size(a)
        return p
    size = getattr(axis, "size", None)
    if isinstance(size, int):
        return size
    from ..topology import bound_axis

    mesh = bound_axis(axis) if isinstance(axis, str) else None
    if mesh is not None:
        return int(mesh.size)
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def record(fn, args, pre=()) -> Tuple[DispatchGraph, Any, List[Optional[int]]]:
    """``(graph, result, value ids of pre)``: ``fn(*args)`` recorded, with
    the tensors of ``pre`` registered first as values that exist before
    the call."""
    rec = GraphRecorder()
    pre_ids = [rec.value_id(t) if hasattr(t, "untyped_storage") else None
               for t in pre]
    with rec:
        out = fn(*args)
    return rec.finish(out), out, pre_ids
