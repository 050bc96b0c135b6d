"""Rolling-window anomaly detection for training runs.

A copy of ``chainermn_tpu/observability/anomaly.py`` (stdlib only): the
four detector families and the trainer extension that runs them.

* :class:`StepTimeSpikeDetector`: EWMA + EW-variance z-score on the
  per-iteration wall clock (a wedging rank, a throttled card, a noisy
  neighbour), before the Watchdog's hard timeout;
* :class:`LossAnomalyDetector`: NaN / Inf at once, and divergence (the
  loss a configurable factor above its exponential baseline);
* :class:`CommBytesDriftDetector`: a step moves the same bytes every
  iteration; per-step comm bytes drifting from the warm-up baseline mean
  a changed program or a collective that stopped being booked;
* :class:`MFUDropDetector`: a sustained utilisation collapse against the
  run's own peak.

Detectors are host-side arithmetic over scalars the caller already has
(no device synchronisation beyond what the caller forced) and reach the
trainer through :class:`HealthMonitor`, whose findings become trace
instant events, one JSON log line each on stderr, flight-recorder events
and calls to a pluggable ``escalate`` callback (the policy is the
caller's, the detection is here).
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import trace
from .comm import get_accountant


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


class Ewma:
    """Exponentially-weighted mean + variance (West's recurrence)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, v: float) -> None:
        v = float(v)
        if self.n == 0:
            self.mean = v
        else:
            d = v - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


class Detector:
    """One named check over a scalar stream.

    ``update(value, iteration)`` returns a finding dict (``kind``,
    ``iteration``, ``value``, ``expected``, ``detail``) when the value is
    anomalous, else None.  Detectors keep their own rolling state; a None
    value (metric absent this iteration) is skipped without advancing the
    baseline.
    """

    #: observation-side metric this detector consumes (HealthMonitor key).
    metric = ""
    kind = ""

    def update(self, value, iteration: int) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def _finding(self, iteration: int, value, expected,
                 detail: str) -> Dict[str, Any]:
        return {"kind": self.kind, "metric": self.metric,
                "iteration": int(iteration), "value": float(value),
                "expected": expected, "detail": detail}


class StepTimeSpikeDetector(Detector):
    """Step-time spike: z-score vs an EWMA baseline.

    ``threshold_z`` sigmas above the EW mean (and at least
    ``min_ratio``× it — the z-score alone misfires when early variance is
    ~0) after ``warmup`` clean iterations.  The spike sample is NOT folded
    into the baseline (a wedged run must keep alarming, not teach the
    baseline that slow is normal).
    """

    metric = "step_time_s"
    kind = "step_time_spike"

    def __init__(self, threshold_z: float = 4.0, min_ratio: float = 1.5,
                 warmup: int = 5, alpha: float = 0.2):
        self.threshold_z = float(threshold_z)
        self.min_ratio = float(min_ratio)
        self.warmup = int(warmup)
        self._ewma = Ewma(alpha)

    def update(self, value, iteration):
        if value is None or not _finite(value):
            return None
        v = float(value)
        e = self._ewma
        if e.n >= self.warmup and e.mean > 0:
            sigma = max(e.std, 1e-12)
            z = (v - e.mean) / sigma
            if z > self.threshold_z and v > self.min_ratio * e.mean:
                return self._finding(
                    iteration, v, round(e.mean, 6),
                    f"step took {v:.4f}s, {v / e.mean:.1f}x the EWMA "
                    f"baseline {e.mean:.4f}s (z={z:.1f})")
        e.update(v)
        return None


class LossAnomalyDetector(Detector):
    """Loss NaN/Inf (immediate) and divergence (vs the EW baseline).

    Divergence fires when the loss exceeds ``divergence_factor`` × the
    EW mean of the |loss| baseline after ``warmup`` samples — loose
    enough for normal training noise, tight enough that a blown-up run
    alarms within a few iterations.  Non-finite values fire on the very
    first sample: there is no baseline that makes NaN acceptable.
    """

    metric = "loss"
    kind = "loss_anomaly"

    def __init__(self, divergence_factor: float = 3.0, warmup: int = 5,
                 alpha: float = 0.1):
        self.divergence_factor = float(divergence_factor)
        self.warmup = int(warmup)
        self._ewma = Ewma(alpha)

    def update(self, value, iteration):
        if value is None:
            return None
        if not _finite(value):
            return dict(self._finding(
                iteration, float("nan"), None,
                f"loss is non-finite ({value!r})"), kind="loss_nonfinite")
        v = float(value)
        e = self._ewma
        if (e.n >= self.warmup
                and abs(v) > self.divergence_factor * max(abs(e.mean), 1e-12)
                and abs(v) > abs(e.mean)):
            return self._finding(
                iteration, v, round(e.mean, 6),
                f"loss {v:.4g} is {abs(v) / max(abs(e.mean), 1e-12):.1f}x "
                f"the EWMA baseline {e.mean:.4g} — divergence")
        e.update(v)
        return None


class CommBytesDriftDetector(Detector):
    """Per-step comm bytes drifting from the compiled baseline.

    The baseline is the median of the first ``warmup`` per-step byte
    totals (median, not mean: the compile step itself can book extra
    eager traffic).  After that, any step whose total deviates more than
    ``rel_tol`` relatively fires — the step program either recompiled
    with different collectives (shape leak) or a collective went missing
    from the ledger.
    """

    metric = "comm_bytes"
    kind = "comm_bytes_drift"

    def __init__(self, rel_tol: float = 0.25, warmup: int = 3):
        self.rel_tol = float(rel_tol)
        self.warmup = int(warmup)
        self._seen: List[float] = []
        self.baseline: Optional[float] = None

    def update(self, value, iteration):
        if value is None or not _finite(value):
            return None
        v = float(value)
        if self.baseline is None:
            self._seen.append(v)
            if len(self._seen) >= self.warmup:
                s = sorted(self._seen)
                self.baseline = s[len(s) // 2]
            return None
        base = self.baseline
        if base <= 0:
            return None
        drift = abs(v - base) / base
        if drift > self.rel_tol:
            return self._finding(
                iteration, v, base,
                f"comm bytes/step {v:.0f} drifted {drift * 100:.0f}% from "
                f"the warmup baseline {base:.0f} — recompile or unbooked "
                f"collective")
        return None


class MFUDropDetector(Detector):
    """Utilization collapse: MFU under ``frac`` × the run's rolling peak
    for ``patience`` consecutive iterations (one slow step is the spike
    detector's job; a sustained drop is a different failure)."""

    metric = "mfu"
    kind = "mfu_drop"

    def __init__(self, frac: float = 0.5, warmup: int = 5,
                 patience: int = 3, window: int = 100):
        self.frac = float(frac)
        self.warmup = int(warmup)
        self.patience = int(patience)
        self._peaks = deque(maxlen=int(window))
        self._low = 0

    def update(self, value, iteration):
        if value is None or not _finite(value):
            return None
        v = float(value)
        peak = max(self._peaks) if self._peaks else 0.0
        self._peaks.append(v)
        if len(self._peaks) <= self.warmup or peak <= 0:
            return None
        if v < self.frac * peak:
            self._low += 1
            if self._low >= self.patience:
                self._low = 0
                return self._finding(
                    iteration, v, round(peak, 4),
                    f"MFU {v:.3f} below {self.frac:.0%} of rolling peak "
                    f"{peak:.3f} for {self.patience} consecutive steps")
        else:
            self._low = 0
        return None


def default_detectors() -> List[Detector]:
    return [StepTimeSpikeDetector(), LossAnomalyDetector(),
            CommBytesDriftDetector(), MFUDropDetector()]


class HealthMonitor:
    """Trainer extension running the detector battery every iteration.

    Metric sourcing (all host-side values other code already produced —
    the monitor forces **no** extra device syncs):

    * ``step_time_s`` — the updater's phase stamps plus the previous
      extension pass (same accounting as StepBreakdownReport);
    * ``loss`` — ``trainer.observation[loss_key]`` *when it is already a
      host scalar or* ``sync_loss=True`` (default: True — one scalar
      readback per check; set ``loss_every > 1`` to amortize it on the
      card);
    * ``comm_bytes`` — the accountant's per-step report;
    * ``mfu`` — ``trainer.observation["perf/mfu"]`` when the
      StepBreakdownReport publishes it.

    Every finding becomes a trace instant event (``anomaly/<kind>``, so
    it lands on the merged cross-rank timeline at the exact step), one
    structured JSON log line on stderr
    (``[chainermn_tpu_torch health] {...}``), and an ``escalate(finding)``
    call.  Escalation policy is the caller's: the default is log-only;
    pass e.g. ``escalate=lambda f: os._exit(44)`` for fail-fast gangs, or
    a checkpoint-then-abort closure.

    Priority 340: after StepBreakdownReport (350) has written the
    breakdown keys, before the ObservationAggregator (300) replaces the
    observation with rank means — the monitor judges THIS rank's local
    values, which is what makes a single slow rank detectable at all.
    """

    trigger = (1, "iteration")
    priority = 340

    def __init__(self, detectors: Optional[List[Detector]] = None,
                 escalate: Optional[Callable[[Dict[str, Any]], None]] = None,
                 loss_key: str = "main/loss", sync_loss: bool = True,
                 loss_every: int = 1, max_findings: int = 1000,
                 log_stream=None):
        self.detectors = (default_detectors() if detectors is None
                          else list(detectors))
        self.escalate = escalate
        self.loss_key = loss_key
        self.sync_loss = bool(sync_loss)
        self.loss_every = max(int(loss_every), 1)
        self.max_findings = int(max_findings)
        self.findings: List[Dict[str, Any]] = []
        self.counts: Dict[str, int] = {}
        self._dropped = 0
        self._log = log_stream  # None → sys.stderr at call time (testable)

    # -- metric assembly --
    def _metrics(self, trainer) -> Dict[str, Optional[float]]:
        updater = trainer.updater
        phases = getattr(updater, "phase_times", None) or {}
        step_t = sum(phases.values()) or None
        ext_t = getattr(trainer, "last_extension_time", None)
        if step_t is not None and ext_t is not None:
            step_t += ext_t
        loss = None
        if self.loss_key in trainer.observation \
                and trainer.iteration % self.loss_every == 0:
            raw = trainer.observation[self.loss_key]
            if isinstance(raw, (int, float)):
                loss = float(raw)
            elif self.sync_loss:
                try:
                    loss = float(raw)  # device scalar readback
                except (TypeError, ValueError):
                    loss = None
        rep = get_accountant().last_step_report
        comm_bytes = float(rep["bytes"]) if rep is not None else None
        mfu = trainer.observation.get("perf/mfu")
        mfu = float(mfu) if isinstance(mfu, (int, float)) else None
        return {"step_time_s": step_t, "loss": loss,
                "comm_bytes": comm_bytes, "mfu": mfu}

    # -- extension surface --
    def observe(self, trainer) -> None:
        metrics = self._metrics(trainer)
        it = trainer.iteration
        for det in self.detectors:
            finding = det.update(metrics.get(det.metric), it)
            if finding is not None:
                self._emit(finding)

    def __call__(self, trainer) -> None:
        pass

    # -- finding fan-out --
    def _emit(self, finding: Dict[str, Any]) -> None:
        self.counts[finding["kind"]] = self.counts.get(finding["kind"], 0) + 1
        if len(self.findings) < self.max_findings:
            self.findings.append(finding)
        else:
            self._dropped += 1
        tr = trace.get_tracer()
        tr.instant(f"anomaly/{finding['kind']}", cat="anomaly",
                   **{k: v for k, v in finding.items() if k != "kind"})
        from . import flight as _flight
        _flight.note("anomaly", finding_kind=finding["kind"],
                     **{k: v for k, v in finding.items() if k != "kind"})
        line = dict(finding, ts=round(time.time(), 3))
        print(f"[chainermn_tpu_torch health] "
              f"{json.dumps(line, sort_keys=True)}",
              file=self._log or sys.stderr, flush=True)
        if self.escalate is not None:
            try:
                self.escalate(finding)
            except Exception as e:  # escalation must not kill detection
                print(f"[chainermn_tpu_torch health] escalation callback "
                      f"failed: {e!r}", file=self._log or sys.stderr,
                      flush=True)

    def health(self) -> Dict[str, Any]:
        """Monitor's contribution to ``export.health_snapshot``."""
        return {"counts": dict(self.counts),
                "findings": list(self.findings[-50:]),
                "findings_dropped": self._dropped}

    # resume contract: detectors re-warm after a resume; counts persist
    def state_dict(self) -> dict:
        return {"counts": dict(self.counts)}

    def load_state_dict(self, state: dict) -> None:
        self.counts = dict(state.get("counts", {}))
