"""Continuous-batching serving: scheduler, slot pool, decode engine, frontend.

Counterpart of ``chainermn_tpu/serving`` for one engine on one card.
"""

from .cache_pool import CachePool, SlotAllocator
from .engine import DecodeEngine
from .frontend import RequestHandle, ServingEngine
from .scheduler import AdmissionError, Request, Scheduler

__all__ = ["AdmissionError", "CachePool", "DecodeEngine", "Request",
           "RequestHandle", "Scheduler", "ServingEngine", "SlotAllocator"]
