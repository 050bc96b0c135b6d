"""Training loop with extension slots.

Counterpart of ``chainermn_tpu/training/``: the reference plugs into
Chainer's ``Trainer`` / ``Updater`` / ``Extension`` machinery; this is the
same architecture — an updater that advances one iteration, a trainer
that fires prioritized extensions on interval triggers — around the
port's eager data-parallel steps.
"""

from . import extensions  # noqa: F401
from .trainer import Extension, Trainer, make_extension  # noqa: F401
from .triggers import IntervalTrigger, get_trigger  # noqa: F401
from .updaters import StandardUpdater  # noqa: F401

__all__ = [
    "Trainer",
    "Extension",
    "make_extension",
    "IntervalTrigger",
    "get_trigger",
    "StandardUpdater",
    "extensions",
]
