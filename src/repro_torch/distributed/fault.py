"""Fault tolerance and elasticity for the training plane (port of
``repro/distributed/fault.py``).

NOT to be confused with ``distributed.faults`` (plural), the serving
plane's deterministic fault-INJECTION harness, whose ``ShardHealth``
runs one ``StepMonitor`` per shard over query wall times, and
``train.TrainLoop`` one over step wall times.

1. Heartbeat / straggler detection (``StepMonitor``): per-step wall
   times feed a robust (median + MAD) estimator; steps slower than
   ``straggler_factor`` x median raise a straggler event, and a missing
   heartbeat past ``dead_after_s`` marks the worker dead.
2. Deadline-skipped microbatches (``GradSkipPolicy``): the accumulated
   gradient is renormalised by the microbatches completed.
3. Elastic re-meshing (``remesh``, ``healthy_mesh_shape``): a sharded
   tree's global leaves re-placed onto another mesh's layout.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import gather_tree, shard_tree


@dataclass
class StepEvent:
    kind: str          # "ok" | "straggler" | "dead"
    step: int
    wall_s: float
    detail: str = ""


class StepMonitor:
    def __init__(self, *, straggler_factor: float = 2.5,
                 dead_after_s: float = 300.0, window: int = 64,
                 mad_factor: Optional[float] = None,
                 source: str = ""):
        """``mad_factor`` (optional) adds a robust absolute-deviation
        term to the threshold: a step is a straggler when its wall time
        exceeds ``max(factor * median, median + mad_factor * MAD)``.
        The additive MAD term keeps near-zero-latency workloads (e.g.
        sub-ms shard queries, where any scheduler hiccup is a large
        RATIO but a tiny absolute delay) from flagging noise, while the
        multiplicative term still catches slow-but-steady drift. None
        keeps the ratio-only rule.

        ``source`` (optional) names this monitor in the unified obs
        event stream (``repro_torch.obs``): with a source set,
        heartbeats bump a per-source counter and straggler/liveness
        verdicts land as ``ObsEvent``s in the process registry — the
        SAME record type the serving plane's ``ShardHealth`` emits. An
        unnamed monitor (the default) stays off the obs plane."""
        self.factor = straggler_factor
        self.mad_factor = mad_factor
        self.dead_after_s = dead_after_s
        self.times: Deque[float] = deque(maxlen=window)
        self.last_beat = time.monotonic()
        self.events: List[StepEvent] = []
        self.source = source

    def _obs(self):
        from repro_torch.obs.metrics import default_registry
        return default_registry()

    def heartbeat(self, step: int, wall_s: float) -> StepEvent:
        self.last_beat = time.monotonic()
        if self.times:
            hist = np.asarray(self.times)
            med = float(np.median(hist))
            mad = float(np.median(np.abs(hist - med)))
        else:
            med, mad = wall_s, 0.0
        self.times.append(wall_s)
        thresh = self.factor * med
        if self.mad_factor is not None:
            thresh = max(thresh, med + self.mad_factor * mad)
        if len(self.times) >= 8 and wall_s > thresh:
            ev = StepEvent("straggler", step, wall_s,
                           f"{wall_s:.2f}s vs median {med:.2f}s "
                           f"(mad {mad:.3f}s)")
        else:
            ev = StepEvent("ok", step, wall_s)
        self.events.append(ev)
        if self.source:
            reg = self._obs()
            reg.counter("phnsw_heartbeats_total",
                        "monitor heartbeats by source",
                        labels=("source",)).labels(
                            source=self.source).inc()
            if ev.kind == "straggler":
                reg.emit("straggler", source=self.source, target=step,
                         detail=ev.detail)
        return ev

    def check_liveness(self) -> Optional[StepEvent]:
        gap = time.monotonic() - self.last_beat
        if gap > self.dead_after_s:
            ev = StepEvent("dead", -1, gap, f"no heartbeat for {gap:.0f}s")
            self.events.append(ev)
            if self.source:
                self._obs().emit("dead", source=self.source,
                                 detail=ev.detail)
            return ev
        return None


# --------------------------------------------------------------------------
# 2. straggler mitigation: deadline-skipped microbatches
# --------------------------------------------------------------------------

@dataclass
class GradSkipPolicy:
    """Tracks how many microbatches completed before the deadline; the
    train loop divides the accumulated gradient by ``completed`` instead
    of the planned count. Skipping is bounded so the batch never shrinks
    below ``min_fraction`` of plan."""
    planned: int
    min_fraction: float = 0.5
    completed: int = 0
    skipped_total: int = 0

    def complete(self, n: int = 1):
        self.completed += n

    def should_skip_rest(self, elapsed_s: float, deadline_s: float) -> bool:
        if elapsed_s < deadline_s:
            return False
        return self.completed >= max(1, int(self.planned * self.min_fraction))

    def renorm(self) -> float:
        """Gradient renormalization factor (planned/completed)."""
        self.skipped_total += self.planned - self.completed
        return self.planned / max(self.completed, 1)


# --------------------------------------------------------------------------
# 3. elastic re-meshing
# --------------------------------------------------------------------------

def remesh(tree, shardings_new):
    """Re-place a (restored or live) tree onto a new mesh's shardings
    (nested dicts of ``sharding.NamedSharding``) through the host: each
    ``Sharded`` leaf (or tensor) is gathered to the CPU as its global
    tensor and placed anew, so any mesh shape takes any other's leaves,
    bit for bit. The new blocks carry no autograd history."""
    with torch.no_grad():
        host = gather_tree(tree, torch.device("cpu"))
    return shard_tree(host, shardings_new)


def healthy_mesh_shape(n_healthy: int, model_parallel: int = 16):
    """Largest (data, model) mesh that fits the healthy-device count,
    keeping the model axis fixed (weights layout unchanged) and shrinking
    the data axis; grad-accum rises to keep global batch constant."""
    data = n_healthy // model_parallel
    if data < 1:
        raise RuntimeError("not enough healthy devices for model parallelism")
    return (data, model_parallel)
