"""Pluggable filter stage for the pHNSW traversal (port of
``repro/core/filters.py``).

Four interchangeable implementations behind one contract:

  * ``PCAFilter``  — the paper's dense low-dim projection (Dist.L).
  * ``PQFilter``   — Flash-style product quantization: uint8 codes
    scored by the ADC expand kernel.
  * ``CascadeFilter`` — traverse on PQ codes, promote through PCA rows
    (a side-car off the layout-(3) stream), one deferred Dist.H pass.
  * ``IdentityFilter`` — filter bypass: every neighbor goes straight to
    Dist.H (HNSW-Std, kept as a measured baseline).

A ``FilterSpec`` owns its build-time payload (``encode``; the cascade's
side-car ``encode_mid``), its per-query preparation (``prepare`` on the
host in numpy, ``prepare_torch`` on a tensor's device, in place of the
reference's ``prepare_jnp``), its host distance oracles (``dists``,
``mid_dists``), its device expand op (``expand``) and its byte and
depth pricing (``bytes_per_vec``, ``cost_dims``, ``mid_bytes_per_vec``,
``mid_cost_dims``). ``from_reference`` carries a reference filter's
parameters across as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.pca import PCA, fit_pca
from repro_torch.core.pq import (PQCodebook, adc_table_batch,
                                 adc_tables_torch, encode_pq, train_pq)
from repro_torch.kernels import ops

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


class FilterSpec:
    """Contract shared by the filter kinds. ``kind`` selects the expand
    pipeline of the search (one per kind)."""

    kind: str = "?"

    def encode(self, x: np.ndarray) -> np.ndarray:
        """x [N, D] -> payload rows [N, P] (host array; P may be 0)."""
        raise NotImplementedError

    @property
    def payload_dtype(self) -> np.dtype:
        raise NotImplementedError

    @property
    def bytes_per_vec(self) -> int:
        """Layout-(3) inline payload bytes per vector."""
        raise NotImplementedError

    @property
    def cost_dims(self) -> int:
        """Per-point filter-distance depth (d_low for PCA, n_sub table
        lookups for PQ)."""
        raise NotImplementedError

    def prepare(self, q: np.ndarray) -> np.ndarray:
        """q [B, D] -> host per-query filter data (f32)."""
        raise NotImplementedError

    def prepare_torch(self, q: torch.Tensor) -> torch.Tensor:
        """Device-side ``prepare`` (tensor in, f32 tensor out on the same
        device)."""
        raise NotImplementedError

    def dists(self, qprep_row: np.ndarray, payload: np.ndarray
              ) -> np.ndarray:
        """One query's filter distances: qprep_row = prepare(q)[i],
        payload [M, P] -> [M] f32."""
        raise NotImplementedError

    def expand(self, nb_payload, qprep, valid, th, k: int):
        """The fused expansion filter stage for this kind (see
        ``ops.fused_expand`` / ``ops.pq_adc_expand``)."""
        raise NotImplementedError


class _DeviceCodebook:
    """The codebook's centroids as a tensor per device, uploaded on first
    use (the codebook is frozen after training)."""

    def _cents(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._cents_dev:
            self._cents_dev[key] = torch.as_tensor(self.cb.centroids,
                                                   device=device)
        return self._cents_dev[key]


@dataclass
class PCAFilter(FilterSpec):
    """The paper's filter: dense projection to d_low dims."""
    pca: PCA
    low_dtype: str = "float32"   # device storage dtype of the payload

    kind = "pca"

    def encode(self, x):
        return self.pca.transform(x).astype(np.float32)

    @property
    def payload_dtype(self):
        return np.dtype(np.float32)

    @property
    def bytes_per_vec(self):
        return self.pca.d_low * _ITEMSIZE[self.low_dtype]

    @property
    def cost_dims(self):
        return self.pca.d_low

    def prepare(self, q):
        return self.pca.transform(q).astype(np.float32)

    def prepare_torch(self, q):
        return self.pca.transform_torch(q)

    def dists(self, qprep_row, payload):
        d = payload.astype(np.float32) - qprep_row
        return np.einsum("ij,ij->i", d, d)

    def expand(self, nb_payload, qprep, valid, th, k):
        return ops.fused_expand(nb_payload, qprep, valid, th, k)


@dataclass
class PQFilter(_DeviceCodebook, FilterSpec):
    """Flash-style PQ filter: n_sub uint8 codes per vector, scored with
    per-query ADC lookup tables."""
    cb: PQCodebook
    _cents_dev: Dict[str, torch.Tensor] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    kind = "pq"

    def encode(self, x):
        return encode_pq(self.cb, x)

    @property
    def payload_dtype(self):
        return np.dtype(np.uint8)

    @property
    def bytes_per_vec(self):
        return self.cb.bytes_per_vec

    @property
    def cost_dims(self):
        return self.cb.n_sub

    def prepare(self, q):
        return adc_table_batch(self.cb, q)

    def prepare_torch(self, q):
        return adc_tables_torch(self._cents(q.device), q)

    def dists(self, qprep_row, payload):
        S = qprep_row.shape[0]
        return qprep_row[np.arange(S)[None, :],
                         payload.astype(np.int64)].sum(1)

    def expand(self, nb_payload, qprep, valid, th, k):
        return ops.pq_adc_expand(nb_payload, qprep, valid, th, k)


@dataclass
class CascadeFilter(_DeviceCodebook, FilterSpec):
    """Multi-stage cascade: traverse on PQ codes, promote the surviving
    ``promote_mult * ef`` candidates through a PCA mid-stage score once
    per layer-0 exit, and defer Dist.H to ONE final batched pass of
    ``rerank_mult * ef`` survivors.

    Inline payload (``encode``): uint8 PQ codes. Side-car payload
    (``encode_mid``): f32 PCA rows, stored off the layout-(3) stream
    (``PackedDB.low2``). Per-query prep is ONE flat f32 row
    ``[n_sub*256 + d_low]``: the ADC tables flattened, then the
    PCA-projected query."""
    cb: PQCodebook
    pca: PCA
    _cents_dev: Dict[str, torch.Tensor] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    kind = "cascade"

    def encode(self, x):
        return encode_pq(self.cb, x)

    @property
    def payload_dtype(self):
        return np.dtype(np.uint8)

    @property
    def bytes_per_vec(self):
        return self.cb.bytes_per_vec       # inline codes only

    @property
    def cost_dims(self):
        return self.cb.n_sub               # in-loop ADC depth

    def encode_mid(self, x):
        return self.pca.transform(x).astype(np.float32)

    @property
    def mid_bytes_per_vec(self):
        return self.pca.d_low * 4          # f32 side-car rows

    @property
    def mid_cost_dims(self):
        return self.pca.d_low

    def prepare(self, q):
        luts = adc_table_batch(self.cb, q)
        qp = self.pca.transform(q).astype(np.float32)
        return np.concatenate([luts.reshape(len(q), -1), qp], axis=1)

    def prepare_torch(self, q):
        luts = adc_tables_torch(self._cents(q.device), q)
        qp = self.pca.transform_torch(q)
        return torch.cat([luts.reshape(q.shape[0], -1), qp], dim=1)

    def dists(self, qprep_row, payload):
        S = self.cb.n_sub
        lut = qprep_row[:S * 256].reshape(S, 256)
        return lut[np.arange(S)[None, :],
                   payload.astype(np.int64)].sum(1)

    def mid_dists(self, qprep_row, payload_mid):
        """Promote-stage distances: PCA rows vs the projected query."""
        qp = qprep_row[self.cb.n_sub * 256:]
        d = payload_mid.astype(np.float32) - qp
        return np.einsum("ij,ij->i", d, d)

    def expand(self, nb_payload, qprep, valid, th, k):
        S = self.cb.n_sub
        lut = qprep[:, :S * 256].reshape(qprep.shape[0], S, 256)
        return ops.pq_adc_expand(nb_payload, lut, valid, th, k)


@dataclass
class IdentityFilter(FilterSpec):
    """Filter bypass: no payload, no per-query prep, no expand kernel.
    The engine skips the C_pca stage and ranks every valid neighbor in
    high dim; deferred re-ranking is a no-op for it."""
    dim: int = 0                 # high dim, for cost_dims

    kind = "none"

    def encode(self, x):
        return np.zeros((len(x), 0), np.float32)

    @property
    def payload_dtype(self):
        return np.dtype(np.float32)

    @property
    def bytes_per_vec(self):
        return 0

    @property
    def cost_dims(self):
        return self.dim

    def prepare(self, q):
        return q.astype(np.float32)[:, :0]     # [B, 0] — unused

    def prepare_torch(self, q):
        return q.to(torch.float32)[:, :0]

    def dists(self, qprep_row, payload):
        raise RuntimeError("identity filter has no filter distances; "
                           "the engine ranks in high dim directly")

    def expand(self, nb_payload, qprep, valid, th, k):
        raise RuntimeError("identity filter bypasses the expand kernel")


def make_filter(cfg: PHNSWConfig, x: np.ndarray, *,
                pca: Optional[PCA] = None, seed: int = 0,
                levels: Optional[np.ndarray] = None) -> FilterSpec:
    """Fit the filter selected by ``cfg.filter_kind`` on the dataset.
    A pre-fit ``pca`` is adopted. ``levels`` (optional, [n] per-point
    HNSW level) trains PQ codebooks density-aware: points are weighted
    by ``level + 1``, the number of layers the node appears on."""

    def _train_cb():
        # seeded RANDOM subsample, not a prefix (a sharded build shares
        # one codebook across contiguous shards of x)
        weights = None if levels is None else \
            np.asarray(levels, np.float64) + 1.0
        n_train = min(len(x), 20_000)
        if n_train == len(x):
            xt, wt = x, weights
        else:
            perm = np.random.default_rng(seed).permutation(
                len(x))[:n_train]
            xt = x[perm]
            wt = None if weights is None else weights[perm]
        return train_pq(xt, cfg.pq_n_sub,
                        iters=cfg.pq_train_iters, seed=seed, weights=wt)

    if cfg.filter_kind == "pca":
        return PCAFilter(pca or fit_pca(x, cfg.d_low),
                         low_dtype=cfg.low_dtype)
    if cfg.filter_kind == "pq":
        return PQFilter(_train_cb())
    if cfg.filter_kind == "cascade":
        return CascadeFilter(_train_cb(), pca or fit_pca(x, cfg.d_low))
    if cfg.filter_kind == "none":
        return IdentityFilter(dim=x.shape[1])
    raise ValueError(f"unknown filter kind {cfg.filter_kind!r}")


def from_reference(kind: str, arrays: dict) -> FilterSpec:
    """The port's filter from a reference filter's parameters given as
    numpy arrays: ``mean``/``components``/``explained`` for the PCA
    (kinds "pca" and "cascade"), ``centroids`` for the codebook ("pq"
    and "cascade"), ``dim`` for "none" (and ``low_dtype`` for "pca",
    default float32). Both engines then filter with the very same
    parameters."""
    def _pca():
        return PCA(np.asarray(arrays["mean"], np.float32),
                   np.asarray(arrays["components"], np.float32),
                   np.asarray(arrays["explained"], np.float32))

    def _cb():
        return PQCodebook(np.asarray(arrays["centroids"], np.float32))

    if kind == "pca":
        return PCAFilter(_pca(), low_dtype=arrays.get("low_dtype",
                                                      "float32"))
    if kind == "pq":
        return PQFilter(_cb())
    if kind == "cascade":
        return CascadeFilter(_cb(), _pca())
    if kind == "none":
        return IdentityFilter(dim=int(arrays.get("dim", 0)))
    raise ValueError(f"unknown filter kind {kind!r}")
