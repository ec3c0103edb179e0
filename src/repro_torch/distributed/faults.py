"""Deterministic fault injection for the serving plane and the shard
health it drives (port of ``repro/distributed/faults.py``: the typed
errors, ``FaultEvent``, ``FaultPlan`` with its hooks and ``chaos``, the
``install``/``active``/``clear``/``inject`` registry, ``FaultPolicy``
and ``ShardHealth``; the port imports nothing of the JAX package, so it
keeps its own copy).

A ``FaultPlan`` is a seedable script of failure events — kill/stall/
corrupt a shard, kill a replica, delay a snapshot swap, truncate an npz
snapshot — consumed through small hooks where real failures surface.
The per-shard query wrapper
``core/distributed.probe_shard`` consults it: kill raises
``ShardKilledError`` before the probe runs, stall sleeps, corrupt
garbles the returned candidate lists (caught downstream by
``check_shard_result``). ``index/sharded.py`` consults the mutation hook
(a killed shard rejects its slice of an upsert or delete) and the swap
hook (a delayed publish); ``index/mutable.write_snapshot`` consults the
snapshot hook (a truncated file that ``read_snapshot`` must catch).

Time is LOGICAL: ``plan.tick()`` advances one step per request (or
wherever the caller advances it), and events are active on
``at <= t < until`` — so every failure scenario is reproducible without
real hardware, wall clocks, or races. No plan installed means one
``is None`` check on the hot path.

``FaultPolicy`` and ``ShardHealth`` are the detection side that
``serve/vector_service.py``'s resilient query loop drives: retry,
backoff and deadline knobs, one ``StepMonitor`` per shard over query
wall times, and the dead mark.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.distributed.fault import StepMonitor
from repro_torch.obs.metrics import default_registry


# --------------------------------------------------------------------------
# typed failure errors — the exception surface callers program against
# --------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of every injected / detected serving-plane failure."""


class ShardFaultError(FaultError):
    """A single shard failed to answer (killed, or returned corrupt
    results). The resilient query path catches THIS type — anything
    else is a real bug and propagates."""


class ShardKilledError(ShardFaultError):
    """The shard is down: its probe raises before running."""


class ShardCorruptError(ShardFaultError):
    """The shard answered, but its candidate lists failed the merge
    boundary integrity check (``check_shard_result``)."""


class AllShardsDeadError(FaultError):
    """No shard answered within the request's deadline budget — the
    request cannot be served even in degraded mode."""


class ReplicaDeadError(FaultError):
    """A whole replica (one ``VectorSearchService``) is down."""


class AllReplicasDeadError(FaultError):
    """Every replica in the ``ReplicaSet`` is dead; nothing can serve."""


class SnapshotCorruptError(FaultError):
    """An npz snapshot failed its integrity envelope (unreadable zip,
    checksum mismatch, missing or mismatched format version). Raised by
    ``index.mutable.read_snapshot`` instead of garbage-deserializing —
    the safety rail under replica snapshot shipping."""


# --------------------------------------------------------------------------
# the fault plan
# --------------------------------------------------------------------------

# event kinds (``FaultEvent.kind``)
KILL_SHARD = "kill_shard"            # target = shard id
STALL_SHARD = "stall_shard"          # target = shard id, param = seconds
CORRUPT_SHARD = "corrupt_shard"      # target = shard id
KILL_REPLICA = "kill_replica"        # target = replica id
DELAY_SWAP = "delay_swap"            # param = seconds
TRUNCATE_SNAPSHOT = "truncate_snapshot"  # param = byte fraction kept

KINDS = (KILL_SHARD, STALL_SHARD, CORRUPT_SHARD, KILL_REPLICA,
         DELAY_SWAP, TRUNCATE_SNAPSHOT)


@dataclass
class FaultEvent:
    """One scripted failure: active while ``at <= plan.t < until``
    (``until=None`` = until healed). ``target`` is a shard or replica
    id (-1 = any); ``param`` is the kind-specific knob (stall seconds,
    swap delay seconds, truncation keep-fraction)."""
    kind: str
    target: int = -1
    param: float = 0.0
    at: int = 0
    until: Optional[int] = None


class FaultPlan:
    """A deterministic script of ``FaultEvent``s over logical time.

    ``log`` records every hook firing as ``(t, kind, target)`` — tests
    assert on it to prove an injection actually happened (and that a
    dead-marked shard stops being probed)."""

    def __init__(self, events: Tuple[FaultEvent, ...] = (), *,
                 seed: int = 0):
        self.events: List[FaultEvent] = list(events)
        self.rng = np.random.default_rng(seed)
        self.t = 0
        self.log: List[Tuple[int, str, int]] = []

    # -- scripting ---------------------------------------------------------

    def add(self, kind: str, target: int = -1, *, param: float = 0.0,
            at: Optional[int] = None, until: Optional[int] = None
            ) -> FaultEvent:
        """Schedule an event (default: active from now, until healed)."""
        assert kind in KINDS, f"unknown fault kind {kind!r}"
        ev = FaultEvent(kind, target, param,
                        self.t if at is None else at, until)
        self.events.append(ev)
        return ev

    def heal(self, kind: Optional[str] = None,
             target: Optional[int] = None) -> int:
        """Retire matching events (both None = everything). Returns the
        number healed. The underlying data was never touched — a healed
        shard serves correct results immediately; only the health
        tracker's dead mark (service-side) needs a ``recover``."""
        keep, healed = [], 0
        for ev in self.events:
            if (kind is None or ev.kind == kind) and \
                    (target is None or ev.target == target):
                healed += 1
            else:
                keep.append(ev)
        self.events = keep
        return healed

    def tick(self, n: int = 1) -> None:
        """Advance logical time (the service calls this once per
        request)."""
        self.t += n

    @classmethod
    def chaos(cls, n_shards: int, *, seed: int = 0, horizon: int = 64,
              n_events: int = 4, stall_s: float = 0.01) -> "FaultPlan":
        """A reproducible random plan: ``n_events`` kill/stall/corrupt
        events over ``horizon`` logical steps — same seed, same script."""
        plan = cls(seed=seed)
        kinds = (KILL_SHARD, STALL_SHARD, CORRUPT_SHARD)
        for _ in range(n_events):
            kind = kinds[int(plan.rng.integers(len(kinds)))]
            s = int(plan.rng.integers(n_shards))
            at = int(plan.rng.integers(horizon))
            until = at + int(plan.rng.integers(1, horizon // 2 + 1))
            plan.add(kind, s, param=stall_s, at=at, until=until)
        return plan

    # -- queries -----------------------------------------------------------

    def _active(self, kind: str, target: Optional[int] = None
                ) -> Iterator[FaultEvent]:
        for ev in self.events:
            if ev.kind != kind:
                continue
            if target is not None and ev.target not in (-1, target):
                continue
            if ev.at <= self.t and (ev.until is None or self.t < ev.until):
                yield ev

    def is_active(self, kind: str, target: Optional[int] = None) -> bool:
        return next(self._active(kind, target), None) is not None

    def replica_dead(self, r: int) -> bool:
        return self.is_active(KILL_REPLICA, r)

    # -- hooks (called from the instrumented code paths) -------------------

    def shard_query_hook(self, s: int) -> None:
        """Pre-probe: raise/stall if shard ``s`` is scripted down."""
        if self.is_active(KILL_SHARD, s):
            self.log.append((self.t, KILL_SHARD, s))
            raise ShardKilledError(f"shard {s} killed by fault plan "
                                   f"at t={self.t}")
        for ev in self._active(STALL_SHARD, s):
            self.log.append((self.t, STALL_SHARD, s))
            time.sleep(ev.param)

    def shard_mutation_hook(self, s: int) -> None:
        """Mutations routed to a killed shard fail (the index stays
        unchanged for that shard — callers see the typed error)."""
        if self.is_active(KILL_SHARD, s):
            self.log.append((self.t, KILL_SHARD, s))
            raise ShardKilledError(f"shard {s} down: mutation rejected "
                                   f"at t={self.t}")

    def corrupt_hook(self, s: int, fd: np.ndarray, gi: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Post-probe: deterministically garble shard ``s``'s candidate
        lists (NaN distances + out-of-owner-range ids) so the merge
        boundary check has something real to catch."""
        if not self.is_active(CORRUPT_SHARD, s):
            return fd, gi
        self.log.append((self.t, CORRUPT_SHARD, s))
        fd = np.array(fd, copy=True)
        gi = np.array(gi, copy=True)
        fd[:, 0] = np.nan                       # non-finite distance
        gi[:, :] = np.where(gi >= 0, -gi - 2_000_000_000, gi)  # alien ids
        return fd, gi

    def swap_delay_hook(self) -> float:
        """Pre-publish: sleep out any scripted swap delay; returns the
        seconds slept (0.0 when none active)."""
        total = sum(ev.param for ev in self._active(DELAY_SWAP))
        if total > 0.0:
            self.log.append((self.t, DELAY_SWAP, -1))
            time.sleep(total)
        return total

    def snapshot_hook(self, path) -> None:
        """Post-save: truncate the written snapshot to ``param`` of its
        bytes — load must detect this via the checksum envelope."""
        from pathlib import Path
        for ev in self._active(TRUNCATE_SNAPSHOT):
            p = Path(path)
            size = p.stat().st_size
            keep = max(1, int(size * ev.param))
            with open(p, "r+b") as f:
                f.truncate(keep)
            self.log.append((self.t, TRUNCATE_SNAPSHOT, -1))


# --------------------------------------------------------------------------
# module registry — what the hooks consult
# --------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (hooks fire from now
    on). Returns the plan for chaining."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def active() -> Optional[FaultPlan]:
    """The installed plan, or None (the common, zero-overhead case)."""
    return _ACTIVE


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def inject(plan: FaultPlan):
    """``with inject(FaultPlan(...)) as plan: ...`` — scoped install,
    always cleared on exit (tests never leak a plan into the next)."""
    install(plan)
    try:
        yield plan
    finally:
        clear()



# --------------------------------------------------------------------------
# detection side: per-shard health (StepMonitor per shard + liveness)
# --------------------------------------------------------------------------

@dataclass
class FaultPolicy:
    """Knobs of the service's resilient sharded query path.

    ``deadline_ms`` bounds ONE request's total retry budget; after it,
    the request completes from whichever shards answered (degraded).
    ``backoff_ms`` is the exponential-backoff base between retries to
    the same shard. ``dead_after_failures`` consecutive failures mark a
    shard dead — subsequent requests skip it outright (no retry tax)
    until ``ShardHealth.recover`` un-marks it. ``straggler_factor`` /
    ``mad_factor`` feed the per-shard ``StepMonitor`` (median + MAD
    over query wall times)."""
    deadline_ms: float = 250.0
    max_retries: int = 2
    backoff_ms: float = 5.0
    dead_after_failures: int = 2
    straggler_factor: float = 4.0
    mad_factor: Optional[float] = 6.0
    window: int = 64


class ShardHealth:
    """Per-shard liveness + straggler tracking for the serving path:
    one ``StepMonitor`` per shard fed with query wall times, a
    consecutive-failure counter driving the dead mark, and an event log
    (``(kind, shard, detail)``) for tests' structural assertions.

    Every verdict ALSO lands in the unified obs event stream
    (``repro_torch.obs``) tagged ``source="serve.shard<N>"`` — the same
    ``ObsEvent`` record type ``StepMonitor`` emits."""

    def __init__(self, n_shards: int, policy: FaultPolicy):
        self.policy = policy
        self.monitors = [StepMonitor(straggler_factor=policy.straggler_factor,
                                     mad_factor=policy.mad_factor,
                                     window=policy.window,
                                     source=f"serve.shard{s}")
                         for s in range(n_shards)]
        self.failures = np.zeros(n_shards, np.int64)
        self.dead = np.zeros(n_shards, bool)
        self.events: List[Tuple[str, int, str]] = []
        self._obs = default_registry()
        self._step = 0

    def heartbeat(self, s: int, wall_s: float):
        """A successful shard answer: reset the failure streak, feed the
        monitor; records (and returns) a straggler event if flagged."""
        self._step += 1
        self.failures[s] = 0
        ev = self.monitors[s].heartbeat(self._step, wall_s)
        if ev.kind == "straggler":
            self.events.append(("straggler", s, ev.detail))
        return ev

    def failure(self, s: int, err: Exception) -> bool:
        """A failed shard attempt. Returns True if the streak just
        crossed ``dead_after_failures`` (shard now marked dead)."""
        self.failures[s] += 1
        self.events.append(("failure", s, repr(err)))
        self._obs.emit("failure", source=f"serve.shard{s}", target=s,
                       detail=repr(err))
        if not self.dead[s] and \
                self.failures[s] >= self.policy.dead_after_failures:
            self.mark_dead(s, f"{int(self.failures[s])} consecutive "
                              f"failures")
            return True
        return False

    def mark_dead(self, s: int, reason: str) -> None:
        self.dead[s] = True
        self.events.append(("dead", s, reason))
        self._obs.emit("dead", source=f"serve.shard{s}", target=s,
                       detail=reason)

    def recover(self, s: int) -> None:
        """Un-mark a shard (after the operator / fault plan healed it):
        next request probes it again."""
        self.dead[s] = False
        self.failures[s] = 0
        self.events.append(("recovered", s, ""))
        self._obs.emit("recovered", source=f"serve.shard{s}", target=s)

    def live_mask(self) -> np.ndarray:
        return ~self.dead

    @property
    def n_live(self) -> int:
        return int((~self.dead).sum())
