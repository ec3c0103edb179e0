"""The one traffic generator. A traffic file (``traffic/<mix>.json``)
gives its parameters, and nothing else:

* ``loop``: "closed", the next call starts when the previous call's
  answers are back on the host (bulk jobs and ann-benchmarks' batch
  mode); or "open", calls arrive on their own clock, Poisson at ``rate``
  a second drawn from the seed, each served at its arrival or as soon as
  the service frees up, its latency taken from the scheduled arrival
  (queue wait included, no coordinated omission; the protocol of the
  port's ``bench.load.open_loop_sync``);
* ``batch``: queries a call;
* ``pool``: queries made from the seed (default ``batch``); a call is
  ``batch`` rows of a seeded permutation of the pool, ``RING``
  permutations cut into calls in set-up and served in turn;
* ``k``: neighbours asked for a query;
* ``rate``: calls a second, for an open loop only.

A key or a loop not listed here is refused, so that a traffic file is
never half applied."""
from __future__ import annotations

import time

import numpy as np

RING = 8
LOOPS = ("closed", "open")
KEYS = frozenset({"loop", "batch", "pool", "k", "rate"})


def checked(traffic: dict) -> dict:
    """``traffic`` with ``pool`` filled in, after refusing what the
    generator does not apply."""
    extra = set(traffic) - KEYS
    if extra:
        raise ValueError(f"traffic keys the generator does not apply: "
                         f"{sorted(extra)}")
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"unknown loop {traffic.get('loop')!r}")
    if (traffic["loop"] == "open") != ("rate" in traffic):
        raise ValueError("an open loop, and only an open loop, has a rate")
    t = {"pool": traffic["batch"], **traffic}
    if t["pool"] % t["batch"]:
        raise ValueError("the pool is a whole number of calls")
    return t


def ring(n_pool: int, traffic: dict, seed) -> list:
    """The calls of the ring, each the pool rows it asks for: ``RING``
    seeded permutations of the pool, each cut into calls of ``batch``."""
    rng = np.random.default_rng(seed)
    b = traffic["batch"]
    return [p[a:a + b] for p in (rng.permutation(n_pool)
                                 for _ in range(RING))
            for a in range(0, n_pool, b)]


def arrivals(traffic: dict, seconds: float, seed) -> np.ndarray:
    """An open loop's scheduled arrivals, seconds from the window's start,
    every one before ``seconds``: the same for a seed at any speed."""
    rng = np.random.default_rng(seed)
    rate = traffic["rate"]
    n = int(rate * seconds * 1.5) + 16
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < seconds]


def drive(call, batches, traffic: dict, seconds: float, seed=None) -> dict:
    """Serve ``batches`` (the ring's query arrays, in turn) through
    ``call(batch) -> (dists, ids)`` in the traffic's loop for ``seconds``.
    Returns the records (ring index, dists, ids) and the latency in
    seconds of the calls that answered, the window's seconds from its
    start to the last call's end, and the queries of a call that raised
    (the loop stops there)."""
    if traffic["loop"] == "closed":
        return _serve(call, batches, None, seconds)
    return _serve(call, batches, arrivals(traffic, seconds, seed), seconds)


def _serve(call, batches, due, seconds: float) -> dict:
    """A closed loop where ``due`` is None (each call due as the last
    ends, until ``seconds`` have passed at the end of a call); else the
    calls due at ``due`` seconds from the start."""
    records, lat_s, failed, error = [], [], 0, None
    t0 = end = time.monotonic()
    while due is None or len(records) < len(due):
        r = len(records) % len(batches)
        at = end if due is None else t0 + due[len(records)]
        now = time.monotonic()
        if at > now:
            time.sleep(at - now)
        try:
            fd, fi = call(batches[r])
        except Exception as e:  # a call that fails ends the window
            failed, error = len(batches[r]), repr(e)
            break
        end = time.monotonic()
        records.append((r, fd, fi))
        lat_s.append(end - at)
        if due is None and end - t0 >= seconds:
            break
    return {"records": records, "lat_s": lat_s, "seconds": end - t0,
            "calls": len(records),
            "queries": sum(len(fi) for _, _, fi in records),
            "failed": failed, "error": error}
