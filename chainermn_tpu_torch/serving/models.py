"""Model registry for the heterogeneous fleet.

Counterpart of ``chainermn_tpu/serving/models.py``.  One
:class:`~chainermn_tpu_torch.serving.fleet.FleetRouter` fronts workers
serving different model variants: each worker carries a ``model_id`` (it
rides the hello / lease wire, so the router learns it the fenced way it
learns queue depth), requests may pin a variant, routing scores only
matching workers, and the KV index refuses cross-model slab claims
(``fleet_cache`` keys records by model).

The registry is host bookkeeping: params stay whatever the caller built
(the port's tensor trees).  ``generation`` is the weight generation: a
rolling upgrade (:func:`~chainermn_tpu_torch.serving.fleet.rolling_upgrade`)
registers the same ``model_id`` at ``generation + 1`` and installs it
worker by worker with zero shed.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

DEFAULT_MODEL_ID = "default"


class ModelVariant:
    """One servable variant: id + params + geometry-bearing kwargs.

    ``worker_kwargs`` are the per-variant WorkerRuntime knobs (layer
    count and head_dim live inside ``params``' shapes; pool sizing like
    ``max_total``/``n_slots`` may differ per variant — a small variant
    affords more slots).
    """

    def __init__(self, model_id: str, params, *, head_dim: int,
                 generation: int = 1,
                 worker_kwargs: Optional[Dict[str, Any]] = None):
        if not model_id:
            raise ValueError("model_id must be a non-empty string")
        if int(generation) < 1:
            raise ValueError(f"generation must be >= 1, "
                             f"got {generation}")
        self.model_id = str(model_id)
        self.params = params
        self.head_dim = int(head_dim)
        self.generation = int(generation)
        self.worker_kwargs = dict(worker_kwargs or {})

    def __repr__(self) -> str:
        return (f"ModelVariant({self.model_id!r}, "
                f"gen={self.generation}, head_dim={self.head_dim})")


class ModelRegistry:
    """``model_id`` → newest :class:`ModelVariant`; older generations
    are kept addressable (``get(mid, generation=1)``) so an upgrade can
    compare old/new on the same pinned request.

    Thread-safe: ``rolling_upgrade`` registers generation N+1 from the
    upgrade thread while router scoring / fleet-build threads resolve
    variants concurrently — every ``_variants`` touch happens under
    ``_lock`` (the dict-of-dicts ``setdefault``+insert in
    :meth:`register` is a two-step write; unguarded it races a
    same-model ``get``'s ``max(gens)`` mid-insert)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._variants: Dict[str, Dict[int, ModelVariant]] = {}

    def register(self, variant: ModelVariant) -> ModelVariant:
        with self._lock:
            gens = self._variants.setdefault(variant.model_id, {})
            if variant.generation in gens:
                raise ValueError(
                    f"model {variant.model_id!r} generation "
                    f"{variant.generation} already registered — weight "
                    f"generations are immutable once published")
            gens[variant.generation] = variant
            return variant

    def get(self, model_id: str,
            generation: Optional[int] = None) -> ModelVariant:
        with self._lock:
            gens = self._variants.get(str(model_id))
            if not gens:
                known = sorted(self._variants)
                raise KeyError(f"unknown model_id {model_id!r}; "
                               f"registered: {known}")
            g = max(gens) if generation is None else int(generation)
            if g not in gens:
                raise KeyError(f"model {model_id!r} has no generation "
                               f"{g} (has {sorted(gens)})")
            return gens[g]

    def latest_generation(self, model_id: str) -> int:
        return self.get(model_id).generation

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._variants)

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return str(model_id) in self._variants

    def __len__(self) -> int:
        with self._lock:
            return len(self._variants)
