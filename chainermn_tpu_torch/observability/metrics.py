"""Derived metrics: step-time breakdown, throughput, MFU gauges.

Counterpart of ``chainermn_tpu/observability/metrics.py``.  The trainer
and the updater stamp raw phase times (``StandardUpdater.phase_times``;
``Trainer.last_extension_time`` / ``last_phase``) and the comm ledger
produces per-step byte / call reports; :class:`StepBreakdownReport` turns
them into observation entries that ride the normal reporting path: the
``ObservationAggregator`` rank-means them, ``LogReport`` folds them into
its means, and the ``Watchdog`` heartbeat names the last completed phase.

The peak table is the card's: one row, the H100 SXM (``NVIDIA H100 80GB
HBM3``), at its dense bf16 tensor-core peak and its HBM3 bandwidth (the
public spec sheet).  It is matched on the whole name the card reports, so
a PCIe or NVL H100, the CPU and the JAX package's TPU kinds get ``None``
(no MFU), as JAX returns for a kind its table lacks.  ``chip_smoke.py``
reads its bf16 peak and its bandwidth from here.
"""

from __future__ import annotations

from typing import Optional

from . import trace
from .comm import get_accountant

#: Dense bf16 FLOP/s a card, by the name ``torch.cuda.get_device_name``
#: reports (public spec sheet; the H100 SXM5 at 700 W).
PEAK_BF16_FLOPS = [
    ("NVIDIA H100 80GB HBM3", 989e12),
]

#: HBM bandwidth (bytes/s) a card, by the same name.
HBM_BYTES_PER_S = [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
]


def _lookup(table, device_kind: str) -> Optional[float]:
    kind = str(device_kind).strip().lower()
    for key, value in table:
        if kind == key.lower():
            return value
    return None


def peak_flops_for(device_kind: str) -> Optional[float]:
    """The card's dense bf16 peak, or None (CPU / unknown: MFU is not
    meaningful)."""
    return _lookup(PEAK_BF16_FLOPS, device_kind)


def hbm_bw_for(device_kind: str) -> Optional[float]:
    """The card's HBM bandwidth in bytes/s, or None."""
    return _lookup(HBM_BYTES_PER_S, device_kind)


def _device_kind(updater) -> str:
    """The name of the updater's device: ``torch.cuda.get_device_name``
    for a card, ``"cpu"`` otherwise."""
    import torch

    dev = torch.device(getattr(updater, "device", None) or "cpu")
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


class StepBreakdownReport:
    """Trainer extension publishing the step-time breakdown.

    Observation keys written every iteration (when the sources exist):

    * ``time/data``, ``time/compute``: the updater's phase stamps (batch
      fetch + upload vs the step call).  A card runs the step
      asynchronously, so ``time/compute`` is host time up to the step's
      first synchronisation; the per-iteration total across all phases is
      wall clock;
    * ``time/extensions``: the PREVIOUS iteration's extension pass (this
      extension runs inside the current one);
    * ``time/comm``, ``comm/bytes``, ``comm/calls``: the comm ledger's
      report of the step (the updater brackets its step call);
    * ``throughput/items_per_sec``: from the updater's batch size (or
      ``items_per_step``), also published as a tracer gauge;
    * ``perf/mfu``: when ``flops_per_item`` is given and the card's peak
      is known (:func:`peak_flops_for` of the updater's device) or
      ``peak_flops`` is passed.

    Priority 350: the keys land in the observation before an
    ``ObservationAggregator`` (300) replaces it with rank means, and after
    nothing else; below the ``Watchdog`` (10k).
    """

    trigger = (1, "iteration")
    priority = 350

    def __init__(self, items_per_step: Optional[int] = None,
                 flops_per_item: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        self.items_per_step = items_per_step
        self.flops_per_item = flops_per_item
        self._peak = peak_flops
        self._peak_resolved = peak_flops is not None

    def _peak_flops(self, updater) -> Optional[float]:
        if not self._peak_resolved:
            self._peak_resolved = True
            try:
                self._peak = peak_flops_for(_device_kind(updater))
            except Exception:
                self._peak = None
        return self._peak

    def observe(self, trainer) -> None:
        obs = trainer.observation
        updater = trainer.updater
        phases = getattr(updater, "phase_times", None)
        total = 0.0
        if phases:
            for phase, dt in phases.items():
                obs[f"time/{phase}"] = dt
                total += dt
        ext_t = getattr(trainer, "last_extension_time", None)
        if ext_t is not None:
            obs["time/extensions"] = ext_t
            total += ext_t
        rep = get_accountant().last_step_report
        if rep is not None:
            obs["comm/bytes"] = rep["bytes"]
            obs["comm/calls"] = rep["calls"]
            obs["time/comm"] = rep["host_time_s"]
        items = self.items_per_step or getattr(updater, "last_batch_size",
                                               None)
        tr = trace.get_tracer()
        if items and total > 0:
            ips = items / total
            obs["throughput/items_per_sec"] = ips
            tr.set_gauge("throughput/items_per_sec", ips)
            if self.flops_per_item:
                peak = self._peak_flops(updater)
                if peak:
                    mfu = self.flops_per_item * ips / peak
                    obs["perf/mfu"] = mfu
                    tr.set_gauge("perf/mfu", mfu)

    def __call__(self, trainer) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass
