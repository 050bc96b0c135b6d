"""Call signatures at the kernel-dispatch layer: the port's "programs".

JAX compiles one program per distinct (input shapes and dtypes, static
arguments) of a jitted function, and its jaxpr engine counts them to find
a recompile hazard.  Eager torch compiles nothing per call; what it
launches is decided at the kernel wrappers of ``ops/``, which launch the
ctypes kernels on the card (``_build.library``) and run their plain
versions on the CPU.  So a wrapper's call signature stands where JAX's
program does: the wrapper's name, each tensor argument's shape and dtype,
and the value of every other argument (a static one).  A tensor's VALUES
and its device are not part of it: two decode ticks that differ in token
and position values call the kernels with one signature, on the card as
on the CPU.

:func:`record_signatures` brackets a call and collects the signatures of
the wrappers it runs, in order (the trace engine's program count,
``analysis/trace_engine.py``); the shard-flow analyzer's dispatch-graph
recorder (``analysis/dispatch_graph.py``) opens a bracket of its own that
makes each wrapper call one node of its graph.  A bracket is a hook,
``hook(name, fn, args, kwargs)``, that runs the call; with none open a
wrapper pays one global read.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Callable, Optional

#: The open bracket's hook, ``hook(name, fn, args, kwargs)``, or None.
_RECORDING: Optional[Callable] = None


def _arg_signature(x) -> Any:
    import torch

    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (tuple, list)):
        return tuple(_arg_signature(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return str(x)
    return ("object", type(x).__name__)


def signature(name: str, args, kwargs) -> tuple:
    """``(name, positional signatures, sorted keyword signatures)``."""
    return (name, tuple(_arg_signature(a) for a in args),
            tuple(sorted((k, _arg_signature(v)) for k, v in kwargs.items())))


def dispatch(name: str):
    """Decorator of a kernel wrapper: while a bracket is open, the call
    runs through the bracket's hook."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            hook = _RECORDING
            if hook is not None:
                return hook(name, fn, args, kwargs)
            return fn(*args, **kwargs)
        return wrapper
    return deco


@contextmanager
def dispatch_bracket(hook: Callable, what: str = "dispatch"):
    """Route every kernel-wrapper call made inside the bracket through
    ``hook(name, fn, args, kwargs)``.  Brackets do not nest."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError(f"{what} brackets do not nest")
    _RECORDING = hook
    try:
        yield
    finally:
        _RECORDING = None


@contextmanager
def record_signatures():
    """Collect the signature of every kernel-wrapper call made inside
    the bracket, in order.  Brackets do not nest."""
    seq: list = []

    def hook(name, fn, args, kwargs):
        seq.append(signature(name, args, kwargs))
        return fn(*args, **kwargs)

    with dispatch_bracket(hook, "record_signatures"):
        yield seq
