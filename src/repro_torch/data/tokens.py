"""Synthetic LM tokens (port of ``repro/data/tokens.py``): seeded,
restart-deterministic, bit-equal to the reference (the same numpy
arithmetic). Each step's batch is a function of (seed, step) alone, so a
restarted job regenerates the exact stream from its step counter.
``TokenPipeline`` prefetches them on a thread and moves them to the
device."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import Sharded


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    *, extras: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """One global batch for ``step``. tokens/labels: [batch, seq] int32,
    Zipf-ish over the vocabulary; ``extras``: {name: (shape, dtype)} of
    standard-normal frontend inputs."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    u = rng.random((batch, seq + 1))
    toks = np.minimum((vocab * u ** 2.2).astype(np.int32), vocab - 1)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if extras:
        for name, (shape, dtype) in extras.items():
            out[name] = rng.standard_normal((batch,) + shape).astype(dtype)
    return out


def batch_extras_for(cfg) -> Dict:
    """Frontend-stub inputs per family: whisper's frames, a vlm's
    patch embeddings."""
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = ((cfg.enc_frames, cfg.d_model), np.float32)
    if cfg.vis_tokens:
        extras["patches"] = ((cfg.vis_tokens, cfg.d_model), np.float32)
    return extras


class TokenPipeline:
    """Prefetching iterator of (step, batch) from ``start_step`` on: each
    batch ``synthetic_batch(seed, step, ...)`` at ``shape``'s global
    batch and sequence length, as tensors on ``device`` (the frontend
    extras cast to the config's dtype, as the reference casts them), or,
    with ``shardings`` ({key: ``distributed.sharding.NamedSharding``},
    ``batch_sharding``'s), as ``Sharded`` leaves: each batch block on
    its positions' devices. A thread makes up to ``prefetch`` batches
    ahead; ``close`` stops it."""

    def __init__(self, cfg, shape, *, seed: int = 0, start_step: int = 0,
                 shardings=None, device="cuda", prefetch: int = 2):
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.step = start_step
        self.shardings = shardings
        self.device = torch.device(device)
        self.extras = batch_extras_for(cfg)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, torch.Tensor]:
        b = synthetic_batch(self.seed, step, self.shape.global_batch,
                            self.shape.seq_len, self.cfg.vocab,
                            extras=self.extras)
        out = {k: torch.from_numpy(v) for k, v in b.items()}
        dtype = getattr(torch, self.cfg.dtype)
        for name in self.extras:
            out[name] = out[name].to(dtype)
        return out

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            item = (step, self._make(step))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step
        if self.shardings is not None:
            return step, {k: Sharded.place(v, self.shardings[k])
                          for k, v in batch.items()}
        return step, {k: v.to(self.device) for k, v in batch.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
