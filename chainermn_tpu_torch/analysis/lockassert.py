"""Opt-in runtime lock-order recorder (``CHAINERMN_TPU_TORCH_LOCK_ASSERT=1``).

Counterpart of ``chainermn_tpu/analysis/lockassert.py``, over the port's
package and under its own environment variable.  Both recorders patch
``threading.Lock`` / ``RLock``, and both may be live in one process (the
JAX package's under ``CHAINERMN_TPU_LOCK_ASSERT``).  So this one neither
double-wraps a lock nor hides one from the other recorder:

* it names a lock's creation site by walking up past every recorder's
  factory frame (any ``lockassert.py``), so it sees the real caller
  however the factories are stacked;
* installed over the other recorder, it slots in BENEATH it (as that
  recorder's inner factory), so the other recorder's own frame check
  still sees the real caller and keeps tracking its package's locks;
* it tracks only locks created inside the port's package, and a tracked
  lock's inner lock is a native one.

The static lock graph (``concurrency.lock_graph``) sees only orders the
AST can prove: ``with self.a: with self.b``, intra-class call chains.
Dynamic orders — a callback that takes a foreign lock, a lock handed
across objects, an order that only materializes under a particular
schedule — are invisible to it.  This module closes the gap at TEST
time: with the env var set, every ``threading.Lock``/``RLock`` CREATED
INSIDE the chainermn_tpu_torch package is replaced by a thin recording proxy
(creation-site filtered, so stdlib/third-party locks stay native), each
acquisition while other tracked locks are held records an ordered edge,
and at teardown the UNION of the observed edges with the static graph
must be acyclic — a dynamic edge that closes a static path is a latent
deadlock the AST alone could not see.

Creation sites are keyed ``(abs file, lineno)`` — the same key
``concurrency.lock_sites`` derives statically, so observed edges are
named ``Class.attr -> Class.attr`` in failures.

Wiring: :func:`install_from_env` installs the recorder when the env var
is set; ``tests/test_torch_analysis_concurrency.py`` runs it in a child
process over a CPU serving run (the engine's driver thread and a
two-replica router), and ``chip_smoke.py``'s ``analysis`` phase over the
same on the card.

The proxy is intentionally minimal (acquire/release/context manager/
``locked``): enough for every lock use in this package.  Recording is
O(held) per acquisition with a per-thread held stack; the edge set is
a plain set under one internal (native) lock.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

Site = Tuple[str, int]
Edge = Tuple[Site, Site]

ENV_VAR = "CHAINERMN_TPU_TORCH_LOCK_ASSERT"


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _TrackedLock:
    """Recording proxy over a real lock primitive."""

    def __init__(self, recorder: "LockOrderRecorder", inner, site: Site,
                 reentrant: bool):
        self._recorder = recorder
        self._inner = inner
        self._site = site
        self._reentrant = reentrant

    # the real lock API surface this package uses
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._recorder._note_acquire(self)
        return got

    def release(self):
        self._recorder._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def _is_owned(self):   # Condition(lock) compatibility
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<TrackedLock {self._site[0]}:{self._site[1]}>"


def _recorder_behind(factory):
    """The recorder object a patched ``threading.Lock`` factory closes
    over (one with ``_orig_lock`` / ``_orig_rlock``, as both packages'
    recorders have), or None for a native factory."""
    for cell in getattr(factory, "__closure__", None) or ():
        try:
            obj = cell.cell_contents
        except ValueError:       # an empty cell
            continue
        if hasattr(obj, "_orig_lock") and hasattr(obj, "_orig_rlock"):
            return obj
    return None


def _real_caller(depth: int = 2):
    """The first frame above ``depth`` that is not a recorder's factory
    (any ``lockassert.py``, of either package)."""
    f = sys._getframe(depth)
    while f is not None and \
            os.path.basename(f.f_code.co_filename) == "lockassert.py":
        f = f.f_back
    return f


class LockOrderRecorder:
    """Patches ``threading.Lock``/``RLock`` factories; records the
    acquisition-order edge set of package-created locks."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(root or _package_root())
        self._orig_lock = None
        self._orig_rlock = None
        self._under = None  # the recorder this one slots in beneath
        self._local = threading.local()
        self._mu = None    # native lock guarding the edge set
        self._edges: Dict[Edge, int] = {}   # edge -> observation count
        self.n_tracked = 0
        self.installed = False

    # ---- patching ----
    def install(self) -> "LockOrderRecorder":
        if self.installed:
            return self
        import _thread

        rec = self
        self._mu = _thread.allocate_lock()

        def _site_of_caller() -> Optional[Site]:
            f = _real_caller(3)
            if f is None:
                return None
            path = os.path.abspath(f.f_code.co_filename)
            if path.startswith(rec.root + os.sep):
                return (path, f.f_lineno)
            return None

        def make_lock():
            site = _site_of_caller()
            if site is None:
                return rec._orig_lock()
            rec.n_tracked += 1
            return _TrackedLock(rec, _thread.allocate_lock(), site,
                                reentrant=False)

        def make_rlock():
            site = _site_of_caller()
            if site is None:
                return rec._orig_rlock()
            rec.n_tracked += 1
            return _TrackedLock(rec, _thread.RLock(), site, reentrant=True)

        other = _recorder_behind(threading.Lock)
        if other is not None and other._orig_lock is not None:
            # beneath the other recorder: its factory still runs first
            # and sees the real caller; it hands us what it does not track
            self._under = other
            self._orig_lock, self._orig_rlock = \
                other._orig_lock, other._orig_rlock
            other._orig_lock, other._orig_rlock = make_lock, make_rlock
        else:
            self._orig_lock = threading.Lock
            self._orig_rlock = threading.RLock
            threading.Lock = make_lock
            threading.RLock = make_rlock
        self._factories = (make_lock, make_rlock)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        if self._under is not None:
            if self._under._orig_lock is self._factories[0]:
                self._under._orig_lock = self._orig_lock
                self._under._orig_rlock = self._orig_rlock
            self._under = None
        elif threading.Lock is self._factories[0]:
            threading.Lock = self._orig_lock
            threading.RLock = self._orig_rlock
        else:
            # another recorder went on top and slotted us beneath it:
            # hand it our inner factories instead
            top = _recorder_behind(threading.Lock)
            while top is not None and top._orig_lock is not \
                    self._factories[0]:
                top = _recorder_behind(top._orig_lock)
            if top is not None:
                top._orig_lock = self._orig_lock
                top._orig_rlock = self._orig_rlock
        self.installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # ---- recording ----
    def _held(self) -> List[_TrackedLock]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    def _note_acquire(self, lock: _TrackedLock) -> None:
        held = self._held()
        new_edges = []
        for h in held:
            if h is lock:
                if lock._reentrant:
                    continue   # legal RLock re-entry, not an order
                new_edges.append((h._site, lock._site))
            elif h._site != lock._site:
                new_edges.append((h._site, lock._site))
        held.append(lock)
        if new_edges:
            with self._mu:
                for e in new_edges:
                    self._edges[e] = self._edges.get(e, 0) + 1

    def _note_release(self, lock: _TrackedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    # ---- reporting ----
    def edges(self) -> Set[Edge]:
        if self._mu is None:
            return set()
        with self._mu:
            return set(self._edges)

    def named_edges(self, sites: Dict[Site, Tuple[str, str]]
                    ) -> Set[Tuple[str, str]]:
        """Observed edges named by the STATIC lock table
        (``concurrency.lock_sites``): ``Class.attr`` ids where the
        creation site is known, ``file:line`` otherwise."""
        def name(site: Site) -> str:
            hit = sites.get(site)
            if hit is not None:
                owner, attr = hit
                return f"{owner}.{attr}"
            rel = os.path.relpath(site[0], self.root)
            return f"{rel}:{site[1]}"
        return {(name(a), name(b)) for a, b in self.edges()}


def find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    """A cycle in the (union) edge graph, or None.  Deterministic:
    nodes visited in sorted order."""
    graph: Dict[str, List[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
    for start in sorted(graph):
        stack = [(start, [start])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    return path + [start]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
    return None


def assert_consistent(recorder: LockOrderRecorder,
                      paths: Optional[List[str]] = None) -> Set[
                          Tuple[str, str]]:
    """The teardown assertion: the union of the STATIC lock graph and
    the edges observed at run time must be acyclic.  Returns the named
    dynamic edge set (for reporting); raises ``AssertionError`` naming
    the cycle otherwise."""
    from .concurrency import analyze_lock_surface

    paths = paths or [_package_root()]
    sites, static = analyze_lock_surface(paths)   # one pass, both halves
    dynamic = recorder.named_edges(sites)
    cycle = find_cycle(static | dynamic)
    if cycle:
        only_dyn = sorted(e for e in dynamic if e not in static)
        raise AssertionError(
            "lock-order cycle in the static+observed union graph: "
            + " -> ".join(cycle)
            + f"; dynamic-only edges: {only_dyn} — an order the AST "
              "could not see closed a deadlock cycle "
              "(CHAINERMN_TPU_TORCH_LOCK_ASSERT)")
    return dynamic


def install_from_env(root: Optional[str] = None
                     ) -> Optional[LockOrderRecorder]:
    """A live recorder when ``CHAINERMN_TPU_TORCH_LOCK_ASSERT=1``, else
    None."""
    if os.environ.get(ENV_VAR) != "1":
        return None
    return LockOrderRecorder(root).install()
