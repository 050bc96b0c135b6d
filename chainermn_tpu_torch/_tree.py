"""A minimal pytree: flatten / unflatten with JAX's order and key paths.

The JAX package walks state with ``jax.tree_util``; the port keeps its
own walker so that the checkpoint manifest and the reshard layouts name
the same leaves in the same order in both packages.  The node types are
JAX's built-in ones:

* ``dict`` (keys in sorted order) and ``defaultdict`` (sorted);
  ``OrderedDict`` (insertion order: a module's ``state_dict``);
* ``list`` and ``tuple`` (index order), ``namedtuple`` (field order);
* ``None``: a node with no children.

Everything else is a leaf, torch tensors included.
:func:`flatten_with_path` spells each path as ``jax.tree_util.keystr``
does: ``['key']`` for a dict key
(``repr``), ``[0]`` for an index, ``.name`` for a namedtuple field.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """``(kind, keys, children, aux)`` of a node, or None for a leaf."""
    if x is None:
        return "none", [], [], None
    if isinstance(x, collections.OrderedDict):
        keys = list(x)
        return "odict", keys, [x[k] for k in keys], type(x)
    if isinstance(x, collections.defaultdict):
        keys = sorted(x)
        return "ddict", keys, [x[k] for k in keys], x.default_factory
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict", keys, [x[k] for k in keys], type(x)
    if _is_namedtuple(x):
        return "ntuple", list(x._fields), list(x), type(x)
    if isinstance(x, (list, tuple)):
        return type(x).__name__, list(range(len(x))), list(x), type(x)
    return None


class TreeDef:
    """The structure of a flattened tree (rebuilds it from leaves)."""

    def __init__(self, kind, keys=(), aux=None, children=()):
        self.kind, self.keys, self.aux = kind, list(keys), aux
        self.children: List["TreeDef"] = list(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = self._build(it)
        rest = list(it)
        if rest:
            raise ValueError(f"{len(rest)} leaves too many for this tree")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            try:
                return next(it)
            except StopIteration:
                raise ValueError("too few leaves for this tree") from None
        vals = [c._build(it) for c in self.children]
        if self.kind == "none":
            return None
        if self.kind == "odict":
            return self.aux(zip(self.keys, vals))
        if self.kind == "ddict":
            return collections.defaultdict(self.aux, zip(self.keys, vals))
        if self.kind == "dict":
            return dict(zip(self.keys, vals))
        if self.kind == "ntuple":
            return self.aux(*vals)
        if self.kind == "list":
            return vals
        return self.aux(vals)

    def flatten_up_to(self, tree) -> List[Any]:
        """The subtrees of ``tree`` at this structure's leaves, in order:
        a spec tree built for this structure flattens here even where a
        spec is ``None`` (which, as a node, has no leaves).  Raises
        ``ValueError`` where ``tree`` has another structure."""
        out: List[Any] = []

        def walk(td, x):
            if td.kind == "leaf":
                out.append(x)
                return
            node = _children(x)
            if node is None or node[0] != td.kind or node[1] != td.keys:
                raise ValueError(
                    f"layout has {len(leaves(tree, lambda v: v is None))} "
                    f"leaves but state has {self.num_leaves}: its "
                    f"structure differs from the state's")
            for c, child in zip(td.children, node[2]):
                walk(c, child)

        walk(self, tree)
        return out

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys
                and self.children == other.children)

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.keys})"


def _key_str(kind, key) -> str:
    if kind == "ntuple":
        return f".{key}"
    if kind in ("dict", "odict", "ddict"):
        return f"[{key!r}]"
    return f"[{key}]"


def flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr, leaf), ...], treedef)``, leaves in JAX's order."""
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        node = None if (is_leaf is not None and is_leaf(x)) else _children(x)
        if node is None:
            out.append((path, x))
            return TreeDef("leaf")
        kind, keys, children, aux = node
        return TreeDef(kind, keys, aux,
                       [walk(c, path + _key_str(kind, k))
                        for k, c in zip(keys, children)])

    treedef = walk(tree, "")
    return out, treedef


def flatten(tree, is_leaf=None) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree, is_leaf=None) -> List[Any]:
    return flatten(tree, is_leaf)[0]

