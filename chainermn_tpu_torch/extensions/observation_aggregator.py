"""Cross-rank averaging of reported observations (losses/metrics).

A copy of ``chainermn_tpu/extensions/observation_aggregator.py``
(reference: ``chainermn/extensions/_observation_aggregator.py ::
ObservationAggregator``): averages the Trainer's observation scalars
across ranks before LogReport, so rank 0's log reflects the whole job,
not its local shard.  The dicts ride the communicator's ``allgather_obj``;
tensors (device scalars) are read to the host first, so what crosses the
object lane is plain numbers.  Array leaves are averaged elementwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..communicators.base import CommunicatorBase


def _to_host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.dim() == 0 else v.numpy()
    return v


def _as_numeric(v) -> "np.ndarray | None":
    """float64 view of ``v``, or None when it is not numeric (strings,
    dicts, arbitrary objects riding the observation)."""
    try:
        a = np.asarray(v, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if a.dtype == object:
        return None
    return a


def aggregate_observations(observation: Dict[str, Any],
                           comm: CommunicatorBase) -> Dict[str, Any]:
    """Return the across-rank mean of each entry of ``observation``.

    Non-numeric entries (status strings, config echoes — anything
    ``float64`` cannot hold) are passed through from the first rank that
    reported them instead of crashing the whole aggregation; numeric
    entries whose shapes disagree across ranks raise a ``ValueError``
    that NAMES the offending key (a silent broadcast-mean over mismatched
    shapes would log garbage as if it were a metric).
    """
    gathered = comm.allgather_obj(
        {k: _to_host(v) for k, v in observation.items()})
    keys: list = []
    for g in gathered:  # union, so metrics reported by only some ranks survive
        keys.extend(k for k in g if k not in keys)
    out: Dict[str, Any] = {}
    for key in keys:
        raw = [g[key] for g in gathered if key in g]
        vals = [_as_numeric(v) for v in raw]
        if any(v is None for v in vals):
            # non-numeric on at least one rank: rank-0's (first reporting
            # rank's) value wins, unaveraged
            out[key] = raw[0]
            continue
        shapes = {v.shape for v in vals}
        if len(shapes) > 1:
            raise ValueError(
                f"observation key {key!r} has mismatched shapes across "
                f"ranks: {sorted(shapes)} — ranks must report the same "
                f"shape (or rename per-rank variants)")
        out[key] = (np.mean(vals, axis=0) if vals[0].ndim
                    else float(np.mean(vals)))
    return out


class ObservationAggregator:
    """Trainer extension: replace ``trainer.observation`` with rank means."""

    def __init__(self, comm: CommunicatorBase):
        self.comm = comm

    def __call__(self, trainer) -> None:
        trainer.observation = aggregate_observations(trainer.observation, self.comm)
