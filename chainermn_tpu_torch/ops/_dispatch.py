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
``analysis/trace_engine.py``).  With no bracket open a wrapper pays one
global read.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Optional

#: The open :func:`record_signatures` bracket's list, or None.
_RECORDING: Optional[list] = None


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
    """Decorator of a kernel wrapper: records its call signature while a
    :func:`record_signatures` bracket is open."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = _RECORDING
            if rec is not None:
                rec.append(signature(name, args, kwargs))
            return fn(*args, **kwargs)
        return wrapper
    return deco


@contextmanager
def record_signatures():
    """Collect the signature of every kernel-wrapper call made inside
    the bracket, in order.  Brackets do not nest."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("record_signatures brackets do not nest")
    seq: list = []
    _RECORDING = seq
    try:
        yield seq
    finally:
        _RECORDING = None
