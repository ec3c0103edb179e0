"""Batched fixed-shape pHNSW search in PyTorch (port of
``repro/core/search_jax.py``, the query path).

B queries run Algorithm 1 together, as in the reference:

  * packed layout (3) as a device tensor ``packed_low[N, M, dl]`` — one
    row gather per expansion fetches indices and all neighbor low-dim
    vectors;
  * the fused expand kernels (``ops.fused_expand_rows``; for PQ codes
    ``ops.pq_expand_rows``), which gather the popped rows themselves:
    Dist.L or ADC, the adjacency/active mask, the C_pca threshold and
    kSort.L in one launch;
  * sorted frontiers: C (candidates), F (finals) and C_pca stay
    ascending, so the pop is slot 0 and every per-step fold is an
    O(ef+k) sorted merge; one op (``ops.trip_fold``) does a trip's pop,
    accept test and all three merges;
  * fixed-capacity buffers with masked updates and a per-query visited
    BITMAP (one bit per node in int32 words, bit 31 included);
  * per-query ``done`` flags latched in the loop state. A latched query
    expands nothing, so its F, ``nsteps`` and ``dhe`` stop changing: the
    loop runs at most ``ceil(steps / W)`` trips and tests ``done.all()``
    on the host only every ``DONE_CHECK_EVERY`` trips, with results
    bit-identical to an exit at the first all-done trip;
  * the search is a generator (``_search_gen``) that yields just before
    each of those host reads. ``_drain`` runs one search to its end; the
    mesh path (``core/distributed.py``) runs the searches of every shard
    in lockstep (``_lockstep``), so each issues its trips before any
    waits on a device.

The filter kinds are those of ``core/filters.py``: "pca" (Dist.L on
float32 or bfloat16 rows, the fused expand kernel), "pq" (uint8 ADC codes, the PQ
expand kernel), "cascade" (PQ codes inline, a PCA side-car ``low2`` for
the promote stage) and "none" (the filter bypass). Re-ranking is per
step or deferred: a deferred search traverses on filter distances only
and re-ranks the final list with ONE batched Dist.H per query (the
deferred cascade first trims a wider PQ-space list through ``dist_l``
on the side-car rows). Tombstones (``PackedDB.deleted``, a word-packed
bitmap) are traversed but never returned. The pca payload is stored in
``cfg.low_dtype`` (float32, or bfloat16 to halve the layout-(3) stream,
rounded once when packed); the kernels read bfloat16 rows as they are
and widen them, so distances are f32 either way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF, VALID_MAX
from repro_torch.core.graph import HNSWGraph
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rank_sort_with_payload as \
    _rank_sort_with_payload
from repro_torch.kernels.ref import shard_base as _shard_base
from repro_torch.kernels.ref import tombstone_bit as _tombstone_bit

# host check of done.all() every this many loop trips (a device->host
# sync); extra trips after every query latched are exact no-ops
DONE_CHECK_EVERY = 8

# trips of the layer body run on the host, by kind: "slotted" (the
# scheduler's stepper, gated per slot) and "layer" (every other layer
# loop: the synchronous search, the descents, the insert probe). A trip
# over a stacked view is one trip for all its shards.
_TRIPS = {"slotted": 0, "layer": 0}


def trip_counts() -> dict:
    """The layer-body trips run since ``reset_trip_counts``, by kind."""
    return dict(_TRIPS)


def reset_trip_counts() -> None:
    for kind in _TRIPS:
        _TRIPS[kind] = 0


@dataclass
class PackedLayer:
    adj: torch.Tensor          # [N, M] int32, -1 padded
    packed_low: torch.Tensor   # [N, M, dl] neighbor low-dim data, inline


@dataclass
class PackedDB:
    """Device-resident database in the paper's layout (3).

    ``filter_kind`` says which filter stage the payload in ``low`` and
    every ``packed_low`` belongs to: "pca" (dense low-dim rows, float32
    or bfloat16),
    "pq" (uint8 ADC codes), "cascade" (uint8 ADC codes inline plus a PCA
    side-car) or "none" (zero-width payload: every neighbor goes
    straight to Dist.H).

    ``low2`` is the cascade's SIDE-CAR: f32 PCA rows ``[N, d_low]``,
    stored off the layout-(3) hot stream (never inlined per neighbor)
    and gathered once per query at the promote stage; None for every
    other kind.

    ``deleted`` is the optional word-packed tombstone bitmap,
    ``[ceil(N/32)] int32`` (bit i of word i >> 5 = node i is deleted,
    bit 31 included); None means no tombstones. Deleted nodes are
    TRAVERSED (they stay in the candidate frontier and their neighbors
    are expanded) but never RETURNED (they are kept out of the result
    list F on the output layer).

    STACKED (``core.distributed.stacked_db_view``): every leaf keeps a
    leading shard dim (``adj`` [shards, N, M], ``packed_low`` [shards, N,
    M, P], ``low``, ``high``, ``deleted``, ``low2``) and ``entry`` is the
    host array of the shards' entries. Only the slotted sharded programs take it, their rows
    shard-major; ``search_batched`` refuses it."""
    layers: List[PackedLayer]
    low: torch.Tensor          # [N, P] filter payload rows (P may be 0)
    high: torch.Tensor         # [N, D]
    entry: int
    cfg: PHNSWConfig
    deleted: Optional[torch.Tensor] = None  # [ceil(N/32)] int32 or None
    low2: Optional[torch.Tensor] = None   # [N, dl] promote side-car
    filter_kind: str = "pca"

    @property
    def device(self) -> torch.device:
        return self.high.device

    @property
    def bytes_layout3(self) -> int:
        """Stored bytes under the paper's layout (3): per RESIDENT node
        per layer, the neighbor list with inline low-dim vectors
        (non-padded entries), plus the high-dim table."""
        dl = self.low.shape[1]
        low_bytes = self.low.element_size()
        extra = 0
        for l in self.layers:
            nnz = int((l.adj >= 0).sum())
            extra += nnz * (4 + dl * low_bytes)
        return extra + self.high.numel() * 4

    @property
    def bytes_sidecar(self) -> int:
        """Stored bytes of the cascade's promote side-car (0 without
        one); not part of the layout-(3) inline stream."""
        if self.low2 is None:
            return 0
        return self.low2.numel() * self.low2.element_size()

    @property
    def bytes_layout4(self) -> int:
        idx = sum(int((l.adj >= 0).sum()) * 4 for l in self.layers)
        return idx + self.low.numel() * self.low.element_size() \
            + self.high.numel() * 4


def pack_bitmap(flags: np.ndarray) -> np.ndarray:
    """bool [n] -> int32 words [ceil(n/32)] in the ``_tombstone_bit``
    layout (bit i of word i >> 5 = flags[i]); the tail word is
    zero-padded. The one definition of the tombstone word layout: the
    sharded builder packs through here."""
    nw = -(-len(flags) // 32)
    words = np.zeros(nw, np.uint32)
    ids = np.nonzero(flags)[0].astype(np.uint32)
    np.bitwise_or.at(words, ids // 32, np.uint32(1) << (ids % 32))
    return words.view(np.int32)


# the payload's storage dtypes per filter kind (the first is the
# encoder's)
_PAYLOAD_DTYPES = {"pca": ("float32", "bfloat16"), "pq": ("uint8",),
                   "cascade": ("uint8",), "none": ("float32",)}
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_payload(filter_kind: str, low_dtype: str) -> None:
    if filter_kind not in _PAYLOAD_DTYPES:
        raise ValueError(f"unknown filter kind {filter_kind!r}")
    if low_dtype not in _PAYLOAD_DTYPES[filter_kind]:
        raise ValueError(f"a {filter_kind!r} payload is "
                         f"{' or '.join(_PAYLOAD_DTYPES[filter_kind])}, "
                         f"got {low_dtype}")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of numpy array ``a`` on ``device``. A bfloat16 array (the
    ``ml_dtypes`` type JAX hands out) is carried bit for bit through its
    uint16 view: ``torch.tensor`` refuses that dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16), device=device) \
            .view(torch.bfloat16)
    return torch.tensor(a, device=device)


def build_packed(g: HNSWGraph, x_low: Optional[np.ndarray] = None, *,
                 filt=None, low_dtype: Optional[str] = None,
                 drop_empty_layers: bool = True, device="cuda") -> PackedDB:
    """Pack a graph into layout (3) on ``device``. ``x_low`` is the
    filter payload ([N, P] rows, dense low-dim vectors for the default
    PCA filter); passing ``filt`` (a ``core.filters.FilterSpec``)
    instead encodes the payload from the filter and stamps its kind
    onto the db ("pca" assumed otherwise). ``low_dtype`` (default
    ``g.cfg.low_dtype``) is the PCA payload's storage dtype, "float32" or
    "bfloat16" (the f32 rows rounded once, to nearest even, as the
    reference's ``jnp.asarray`` rounds them); PQ codes always store
    uint8. ``drop_empty_layers``
    drops all-padding top layers (the level assignment rarely reaches
    ``cfg.n_layers``); pass False where layer counts must stay uniform
    (stacked shards). The neighbor-payload gather runs on ``device``."""
    fkind = filt.kind if filt is not None else "pca"
    if x_low is None:
        if filt is None:
            raise ValueError("build_packed needs x_low or filt")
        x_low = filt.encode(g.x)
    x_low = np.asarray(x_low)
    if fkind == "pca":
        dt = low_dtype or g.cfg.low_dtype
        _check_payload(fkind, dt)
        low = torch.as_tensor(x_low.astype(np.float32, copy=False),
                              device=device).to(_TORCH_DTYPE[dt])
    else:
        _check_payload(fkind, str(x_low.dtype))
        low = torch.as_tensor(x_low, device=device)
    adjs = list(g.layers)
    while drop_empty_layers and len(adjs) > 1 and not (adjs[-1] >= 0).any():
        adjs.pop()
    layers = []
    for adj in adjs:
        a = torch.as_tensor(np.asarray(adj, np.int32), device=device)
        packed = low[a.clamp(min=0).long()]                 # [N, M, P]
        packed[a < 0] = 0
        layers.append(PackedLayer(adj=a, packed_low=packed))
    high = torch.as_tensor(np.asarray(g.x, np.float32), device=device)
    low2 = None
    if filt is not None and hasattr(filt, "encode_mid"):
        # the cascade's promote side-car: PCA rows off the hot stream
        low2 = torch.as_tensor(filt.encode_mid(g.x), device=device)
    return PackedDB(layers=layers, low=low, high=high, entry=int(g.entry),
                    cfg=g.cfg, low2=low2, filter_kind=fkind)


def from_reference(db_np: dict, cfg: PHNSWConfig, *,
                   device="cuda") -> PackedDB:
    """The port's PackedDB from a reference ``PackedDB``'s arrays given as
    numpy: ``{"adj": [..], "packed_low": [..], "low", "high", "entry",
    "filter_kind"}`` and, where present, the cascade's ``"low2"`` and the
    tombstone words ``"deleted"`` — so both engines search the very same
    state (bfloat16 arrays included)."""
    _check_payload(db_np["filter_kind"],
                   str(np.asarray(db_np["low"]).dtype))
    t = lambda a: tensor_from_numpy(a, device)
    layers = [PackedLayer(adj=t(a).to(torch.int32), packed_low=t(p))
              for a, p in zip(db_np["adj"], db_np["packed_low"])]
    low2, deleted = db_np.get("low2"), db_np.get("deleted")
    return PackedDB(layers=layers, low=t(db_np["low"]),
                    high=t(db_np["high"]), entry=int(db_np["entry"]),
                    cfg=cfg, low2=None if low2 is None else t(low2),
                    deleted=None if deleted is None
                    else t(deleted).to(torch.int32),
                    filter_kind=db_np["filter_kind"])


def _cascade_lut(qprep, S: int):
    """ADC tables out of the cascade's flat per-query prep:
    [B, S*256 + d_low] -> [B, S, 256], a strided VIEW (row stride
    S*256 + d_low) that the PQ expand kernel reads in place."""
    return qprep[:, :S * 256].reshape(qprep.shape[0], S, 256)


def _cascade_qpca(qprep, S: int):
    """The PCA-projected query out of the cascade's flat prep:
    [B, S*256 + d_low] -> [B, d_low] (the promote-stage operand)."""
    return qprep[:, S * 256:]


def _n_stacked(db) -> int:
    """P of a stacked view (``core.distributed.stacked_db_view``), 0 for
    one db."""
    return int(db.high.shape[0]) if db.high.dim() == 3 else 0


def _row_base(db, B: int, device):
    """[B, 1] int64: each row's shard offset in nodes into the flattened
    stacked leaves of ``db`` (rows shard-major), or None for one db."""
    P = _n_stacked(db)
    return None if not P else _shard_base(B, P, db.high.shape[1], device)


def _gather_rows(table, ids, base=None):
    """table[ids] for ids [B, K] (-1 pads read row 0): [B, K, width]. A
    stacked table [P, N, width] gives row r shard r // (B / P)'s rows
    (``base``: ``_row_base``'s offsets, computed here when None)."""
    B, K = ids.shape
    safe = ids.clamp(min=0)
    if table.dim() == 3:
        if base is None:
            base = _shard_base(B, table.shape[0], table.shape[1], ids.device)
        safe = safe + base
        table = table.flatten(0, 1)
    return table.index_select(0, safe.reshape(-1)).reshape(B, K, -1)


def _bits(ids):
    """Word index (int64, for gather/scatter) and int32 bit mask of each
    id in the visited bitmap; ``1 << 31`` is -2**31 in int32, as in the
    reference."""
    safe = ids.clamp(min=0)
    return (safe // 32).long(), torch.ones_like(safe) << (safe % 32)


def _pad_cols(t, width: int, fill):
    """Pad [B, n] to [B, width] with ``fill`` (no-op when n >= width)."""
    B, n = t.shape
    if n >= width:
        return t
    return torch.cat([t, t.new_full((B, width - n), fill)], 1)


def _layer_init(db: PackedDB, start_d, start_i, *, ef: int, k: int,
                CAP: int, filter_deleted: bool = False):
    """The fixed-capacity SORTED layer state seeded from a start set:
    (C_d, C_i, F_d, F_i, V, Cp). ``filter_deleted`` seeds F with the
    live part of the start set only."""
    B = start_d.shape[0]
    N = db.high.shape[-2]
    dev = start_d.device
    C_d = _pad_cols(start_d, CAP, INF)
    C_i = _pad_cols(start_i, CAP, -1)
    if filter_deleted:
        # the routing layers above may hand over tombstoned entry
        # points: legal to traverse from, illegal to return
        tomb0 = _tombstone_bit(db.deleted, start_i) | (start_i < 0)
        s_d, s_i = _rank_sort_with_payload(
            torch.where(tomb0, INF, start_d),
            torch.where(tomb0, -1, start_i))
        F_d = _pad_cols(s_d, ef, INF)[:, :ef].contiguous()
        F_i = _pad_cols(s_i, ef, -1)[:, :ef].contiguous()
    else:
        F_d, F_i = C_d[:, :ef].contiguous(), C_i[:, :ef].contiguous()
    # visited bitmap: one bit per node in int32 words; the insert is a
    # scatter-add of disjoint bit masks (== bitwise or)
    V = torch.zeros((B, -(-N // 32)), dtype=torch.int32, device=dev)
    w, m = _bits(start_i)
    V.scatter_add_(1, w, torch.where(start_i >= 0, m, 0))
    # C_pca threshold heap (k-bounded filter dists of accepted candidates,
    # ascending; Cp[:, -1] is the filter threshold f_pca)
    Cp = torch.full((B, k), INF, dtype=torch.float32, device=dev)
    return C_d, C_i, F_d, F_i, V, Cp


def _layer_body(db: PackedDB, layer: int, q_high, qprep, *, ef: int,
                k: int, W: int, steps: int, filter_deleted: bool = False,
                deferred: bool = False, ef_eff=None, budget=None):
    """The ONE-expansion-iteration body over the layer state
    ``(C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)``. The visited
    bitmap V is updated in place. ``deferred`` traverses on filter
    distances: no high-dim gather and no Dist.H inside the loop.
    ``filter_deleted`` keeps tombstoned candidates out of F (they still
    enter C and the C_pca heap).

    ``search_layer_batched`` drives it with a static ``steps`` budget;
    the slotted stepper (``_slot_step``) drives the SAME body with two
    per-slot data generalisations, each the static program when None:

    * ``ef_eff`` [B] int32 in [1, ef] — the per-slot effective ef: the
      accept and termination bound is ``F_d[i, ef_eff[i] - 1]`` instead
      of ``F_d[i, -1]`` (the mixed-k and adaptive-ef hook);
    * ``budget`` [B] int32 — the per-slot step budget replacing
      ``steps``: a slot frozen at its budget (or done) neither expands
      nor pops, and resumes where it froze when the budget is raised.
      The reference runs a trip only while some slot can still make
      progress and latches ``done`` on every slot in a trip it runs; a
      trip here takes that test on the device at its start (``go``) and
      latches nothing without it, so the host may check it only every
      ``DONE_CHECK_EVERY`` trips.

    On a stacked view (``core.distributed.stacked_db_view``) the B rows
    are shard-major and each reads its own shard's leaves, as the
    reference's ``vmap`` over the shards: the expand and fold kernels
    take the stacked leaves whole (one launch for every shard), the
    plain gathers read the flattened leaves at each row's shard offset,
    and the slotted test ``go`` is taken per shard (the reference's loop
    test sits inside the ``vmap``: a shard none of whose slots can
    progress runs no trip, and latches nothing, while another does)."""
    B = q_high.shape[0]
    lay = db.layers[layer]
    M = lay.adj.shape[-1]
    fkind = db.filter_kind
    P = _n_stacked(db)
    base = _row_base(db, B, q_high.device)
    if fkind == "none":
        kk = W * M          # filter bypass: every neighbor is a candidate
        deferred = False    # filter space == high-dim space
    else:
        kk = W * k                               # survivors per iteration
    # the PQ tables: the cascade's are a view into its flat prep row,
    # taken once per layer (no per-step copy)
    lut = _cascade_lut(qprep, db.low.shape[-1]) if fkind == "cascade" \
        else qprep
    need_kv_row = fkind != "none" and not deferred
    dev = q_high.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    jj = torch.arange(kk, device=dev)
    later = (jj[:, None] > jj[None, :])[None]              # [1, kk, kk]
    bslot = None if ef_eff is None \
        else (ef_eff.clamp(1, ef) - 1).long()[:, None]
    lim = steps if budget is None else budget[:, None]

    def body(state):
        _TRIPS["slotted" if budget is not None else "layer"] += 1
        C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe = state
        # the accept/termination bound: F.max over the slot's effective
        # result width (the compiled width without per-slot ef)
        bnd = F_d[:, -1:] if bslot is None else torch.gather(F_d, 1, bslot)
        # -- pop the W nearest candidates: slots 0..W-1 of sorted C (the
        #    fold below drops them from C) --
        d_w, c_w = C_d[:, :W], C_i[:, :W]
        # termination is monotone, so the freeze is latched; an exhausted
        # frontier (slot 0 is the -1/INF pad) latches too (lines 7-8)
        latched = done | (C_d[:, 0] > bnd[:, 0]) | (C_i[:, 0] < 0)
        if budget is None:
            done, pop = latched, None
        else:
            # slotted: the trip is real only if some slot can progress
            # (the reference's loop test); a done or budget-frozen slot
            # keeps its frontier unpopped
            can = ~done & (nsteps < budget)
            if P:
                go = can.reshape(P, -1).any(1, keepdim=True)
                done = torch.where(go, latched.reshape(P, -1),
                                   done.reshape(P, -1)).reshape(B)
            else:
                done = torch.where(can.any(), latched, done)
            pop = ~done & (nsteps < budget)
        exp = (d_w <= bnd) & ~done[:, None] & (nsteps[:, None] + lane < lim)
        if fkind in ("pq", "cascade"):
            # -- step 2, fused: the PQ expand reads the W popped rows of
            #    the layer (layout (3) bursts) itself: ADC + mask +
            #    f_pca threshold + kSort.L, the neighbour ids out --
            kv, cand = ops.pq_expand_rows(lay.adj, lay.packed_low, c_w, exp,
                                          lut, Cp[:, -1], kk)
        elif fkind == "pca":
            # -- step 2, fused: the pca expand reads the W popped rows
            #    itself: Dist.L + mask + f_pca threshold + kSort.L --
            kv, cand = ops.fused_expand_rows(lay.adj, lay.packed_low, c_w,
                                             exp, qprep, Cp[:, -1], kk)
        else:
            # filter bypass: every valid neighbor of the W row gathers
            # (paper layout (3) bursts) is a candidate; gated-off slots
            # gather row 0, discarded via the mask
            cand = _gather_rows(lay.adj, torch.where(exp, c_w, 0),
                                base).reshape(B, W * M)
            kv, valid = None, (cand >= 0) & exp.repeat_interleave(M, dim=1)
        if kv is not None:
            valid = (kv < VALID_MAX) & (cand >= 0)
        # -- visited check: one bit gather per candidate --
        cw, cm = _bits(cand)
        seen = (torch.gather(V, 1, cw) & cm) != 0
        if W > 1:
            # intra-iteration dedup: the W neighbor lists may overlap;
            # keep the first occurrence
            dup = ((cand[:, :, None] == cand[:, None, :]) & later
                   & valid[:, None, :]).any(-1)
            seen |= dup
        valid &= ~seen
        if deferred:
            # -- deferred re-rank: traverse on FILTER distances --
            dh = torch.where(valid, kv, INF)
        else:
            # -- step 3: kk irregular high-dim fetches + Dist.H --
            dh = torch.where(valid, ops.dist_h(
                _gather_rows(db.high, cand, base), q_high), INF)
            dhe = dhe + valid.sum(1, dtype=torch.int32)
        # -- mark visited: disjoint bit masks (valid slots are distinct
        #    ids, so the add is a bitwise or); in place --
        V.scatter_add_(1, cw, torch.where(valid, cm, 0))
        # -- the fold, one op: the pop, accept (d < F.max or F not full;
        #    F starts padded with INF), the feeds (an okF row without
        #    tombstones under filter_deleted; the C_pca heap's own kv row
        #    only when the traversal orders by Dist.H, else the C row)
        #    and the O(ef+k) sorted merges into F, C and the heap --
        F_d, F_i, C_d, C_i, Cp_n = ops.trip_fold(
            F_d, F_i, C_d, C_i, W, None if fkind == "none" else Cp, dh,
            cand, kv if need_kv_row else None,
            db.deleted if filter_deleted else None, ef_eff=ef_eff, pop=pop)
        if Cp_n is not None:
            Cp = Cp_n
        nsteps = nsteps + exp.sum(1, dtype=torch.int32)
        return (C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)

    return body


def _all_done(done) -> bool:
    """The host read of a layer loop's ``done`` flags (a device->host
    sync on the card)."""
    return bool(done.all())


def _lockstep(gens) -> list:
    """Run several search generators together: each round resumes every
    unfinished one (its pending host read, then its trips up to the next
    read), so every search issues its first trips before any search
    reads a flag, and a search on one device never waits behind another
    device's read. Returns their values in order."""
    out = [None] * len(gens)
    pending = list(range(len(gens)))
    while pending:
        still = []
        for i in pending:
            try:
                next(gens[i])
                still.append(i)
            except StopIteration as stop:
                out[i] = stop.value
        pending = still
    return out


def _drain(gen):
    """Run one search generator to its end (each host read right after
    its yield); returns its value."""
    return _lockstep([gen])[0]


def search_layer_batched(db: PackedDB, layer: int, q_high, qprep,
                         start_d, start_i, *, ef: int, k: int,
                         max_steps: Optional[int] = None,
                         expand_width: Optional[int] = None,
                         filter_deleted: bool = False,
                         deferred: bool = False):
    """One layer of Algorithm 1 for a batch of queries (``_layer_gen``
    run to its end).

    ``qprep`` is the filter's per-query data (the PCA-projected query
    [B, dl] for "pca", ADC tables [B, S, 256] for "pq", the flat row
    [B, S*256 + dl] for "cascade", a zero-width tensor for "none").
    start_d/start_i: [B, E] entry candidates ascending (FILTER-space
    dists when ``deferred``). Each trip pops the W = ``expand_width``
    (default ``cfg.expand_width``) nearest frontier candidates and
    expands them jointly. ``deferred`` traverses on filter distances only (a no-op
    for the identity filter). ``filter_deleted`` (needs ``db.deleted``)
    applies the tombstone semantics: deleted nodes enter C and the C_pca
    heap and are expanded, but never enter F, so F.max is over live
    nodes and the traversal digs on until ef live results converge.

    Returns (F_dist [B, ef], F_idx [B, ef] ascending, steps [B] int32,
    dist_h [B] int32 = per-query Dist.H evaluations in this layer)."""
    _refuse_stacked(db)
    return _drain(_layer_gen(db, layer, q_high, qprep, start_d, start_i,
                             ef=ef, k=k, max_steps=max_steps,
                             expand_width=expand_width,
                             filter_deleted=filter_deleted,
                             deferred=deferred))


def _layer_gen(db: PackedDB, layer: int, q_high, qprep, start_d, start_i,
               *, ef: int, k: int, max_steps: Optional[int] = None,
               expand_width: Optional[int] = None,
               filter_deleted: bool = False, deferred: bool = False):
    """``search_layer_batched`` as a generator: it yields just before
    each host read of ``done`` and returns the layer's result."""
    B = q_high.shape[0]
    M = db.layers[layer].adj.shape[-1]
    W = expand_width or db.cfg.expand_width
    kk = W * M if db.filter_kind == "none" else W * k
    CAP = max(ef + kk, 8)
    steps = max_steps or db.cfg.max_steps_for_layer(layer)
    iters = -(-steps // W)                       # expansion budget / W
    if filter_deleted and db.deleted is None:
        raise ValueError("filter_deleted needs db.deleted (a tombstone "
                         "bitmap)")
    C_d, C_i, F_d, F_i, V, Cp = _layer_init(db, start_d, start_i, ef=ef,
                                            k=k, CAP=CAP,
                                            filter_deleted=filter_deleted)
    dev = q_high.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    nsteps = torch.zeros((B,), dtype=torch.int32, device=dev)
    dhe = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = (C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)
    body = _layer_body(db, layer, q_high, qprep, ef=ef, k=k, W=W,
                       steps=steps, filter_deleted=filter_deleted,
                       deferred=deferred)
    for t in range(iters):
        if t and t % DONE_CHECK_EVERY == 0:
            yield
            if _all_done(state[6]):
                break
        state = body(state)
    _, _, F_d, F_i, _, _, _, nsteps, dhe = state
    return F_d, F_i, nsteps, dhe


def _entry_ids(db: PackedDB, B: int):
    """The descent's entry column [B, 1] int32: the entry point, or on a
    stacked view each row's shard's entry (the [P] host entries repeated
    shard-major), copied to the device without a host sync."""
    P = _n_stacked(db)
    if not P:
        return torch.full((B, 1), int(db.entry), dtype=torch.int32,
                          device=db.device)
    col = np.repeat(np.asarray(db.entry, np.int32), B // P)[:, None]
    if db.device.type != "cuda":
        return torch.from_numpy(col).to(db.device)
    return torch.from_numpy(col).pin_memory().to(db.device,
                                                 non_blocking=True)


def _entry_start(db: PackedDB, queries):
    """The descent's start set: the entry point and its Dist.H, [B, 1]."""
    ep = _entry_ids(db, queries.shape[0])
    ep_d = ops.dist_h(_gather_rows(db.high, ep), queries)
    return ep_d, ep


def _refuse_stacked(db: PackedDB) -> None:
    if _n_stacked(db):
        raise ValueError("a stacked db (core.distributed.stacked_db_view) "
                         "is not searchable directly: search the "
                         "ShardedDB (shard_search_host) or one shard_db")


def _check_device(db: PackedDB, device) -> None:
    if db.device.type != torch.device(device).type:
        raise ValueError(f"db lives on {db.device}, call asked for {device}")


def probe_neighborhoods(db: PackedDB, queries, qprep, ef: int, k: int,
                        filter_deleted: bool = True,
                        ef_upper: Optional[int] = None, *, device="cuda"):
    """Neighborhood probe for a batch of to-be-inserted vectors: the
    serving traversal run at every layer with the construction beam
    (ef = ef_construction), each layer's full top-ef seeding the next.
    The device half of the wave builder (``core/build.py``).
    ``filter_deleted`` (needs ``db.deleted``) excludes tombstoned nodes
    at EVERY layer: new nodes must never link to the dead. The one-shot
    wave builder passes False (a fresh build has no bitmap).
    ``ef_upper`` narrows the beam at layers above 0. Returns
    ([L, B, ef] dists, [L, B, ef] ids), bottom layer FIRST; upper-layer
    rows are padded to ef width with INF/-1 when ``ef_upper`` trims
    them."""
    _check_device(db, device)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=db.device)
    qprep = torch.as_tensor(qprep, dtype=torch.float32, device=db.device)
    B = queries.shape[0]
    ep_d, ep = _entry_start(db, queries)
    out_d, out_i = [], []
    for layer in range(len(db.layers) - 1, -1, -1):
        ef_l = ef if layer == 0 else min(ef_upper or ef, ef)
        fd, fi, _, _ = search_layer_batched(
            db, layer, queries, qprep, ep_d, ep, ef=ef_l, k=k,
            max_steps=2 * ef_l + 16, filter_deleted=filter_deleted)
        ep_d, ep = fd, fi
        if ef_l < ef:
            fd = torch.cat([fd, fd.new_full((B, ef - ef_l), INF)], 1)
            fi = torch.cat([fi, fi.new_full((B, ef - ef_l), -1)], 1)
        out_d.append(fd)
        out_i.append(fi)
    return torch.stack(out_d[::-1]), torch.stack(out_i[::-1])


def search_batched(db: PackedDB, queries, qprep=None, *, pca=None,
                   filt=None,
                   ef0: Optional[int] = None,
                   k_schedule: Optional[Tuple[int, ...]] = None,
                   entry: Optional[int] = None,
                   return_stats: bool = False,
                   deferred: Optional[bool] = None,
                   rerank_mult: Optional[int] = None,
                   promote_mult: Optional[int] = None,
                   device="cuda"):
    """Full multi-layer pHNSW search for a batch. queries: [B, D] (numpy
    or tensor; moved to the db's device, which must be ``device``).
    Returns (dists [B, ef0], idx [B, ef0]) tensors; with
    ``return_stats=True`` also a dict with ``steps_per_layer``
    [n_layers, B] (top layer first), ``steps_total`` [B],
    ``dist_h_evals`` [B], and ``coverage``/``degraded`` (1.0/False for a
    single shard).

    ``qprep`` is the filter's per-query data; leave it None and pass
    ``filt`` (a ``core.filters.FilterSpec``) or ``pca`` (the PCA-filter
    convenience) to compute it here. The identity filter needs neither.

    ``deferred`` / ``rerank_mult`` select the re-ranking mode (defaults
    from ``db.cfg.deferred_rerank`` / ``db.cfg.rerank_mult``): deferred
    traverses on filter distances only and re-ranks the final
    ``rerank_mult * ef0`` candidates in high dim with ONE batched
    Dist.H call per query. ``promote_mult`` (cascade + deferred only;
    default ``db.cfg.promote_mult``) widens the layer-0 traversal to
    ``promote_mult * ef0`` PQ-space candidates that the PCA promote
    stage trims back to ``rerank_mult * ef0`` before that Dist.H pass.
    ``ef0`` and ``k_schedule`` default to the config's; ``entry``
    overrides the descent entry point. A stacked view
    (``core.distributed.stacked_db_view``) is refused."""
    _refuse_stacked(db)
    if filt is not None and filt.kind != db.filter_kind:
        raise ValueError(f"filter mismatch: db carries a "
                         f"{db.filter_kind!r} payload, filt is "
                         f"{filt.kind!r}")
    _check_device(db, device)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=db.device)
    if qprep is None:
        if filt is not None:
            qprep = filt.prepare_torch(queries)
        elif pca is not None:
            qprep = pca.transform_torch(queries)
        elif db.filter_kind == "none":
            qprep = queries[:, :0]
        else:
            raise ValueError("qprep, filt or pca required for the "
                             f"{db.filter_kind!r} filter")
    qprep = torch.as_tensor(qprep, dtype=torch.float32, device=db.device)
    if entry is not None:
        db = dataclasses.replace(db, entry=int(entry))
    if deferred is None:
        deferred = db.cfg.deferred_rerank
    if rerank_mult is None:
        rerank_mult = db.cfg.rerank_mult
    if promote_mult is None:
        promote_mult = db.cfg.promote_mult
    # the reference's normalisation of the no-op combinations: deferred
    # is a no-op for the identity filter, rerank_mult exists only in
    # deferred mode, promote_mult only for the deferred cascade
    if db.filter_kind == "none":
        deferred = False
    if not deferred:
        rerank_mult = 1
    if not (deferred and db.filter_kind == "cascade"):
        promote_mult = 1
    else:
        # the promote pool can never be narrower than the rerank pool
        promote_mult = max(int(promote_mult), int(rerank_mult))
    fd, fi, steps, dhe = _search_batched_impl(
        db, queries, qprep, ef0=ef0 or db.cfg.ef0,
        k_schedule=k_schedule or db.cfg.k_schedule_for(db.filter_kind,
                                                       bool(deferred)),
        deferred=bool(deferred), rerank_mult=int(rerank_mult),
        promote_mult=int(promote_mult))
    if return_stats:
        return fd, fi, {"steps_per_layer": steps,
                        "steps_total": steps.sum(0),
                        "dist_h_evals": dhe,
                        "coverage": 1.0, "degraded": False}
    return fd, fi


def _descend(db: PackedDB, queries, qprep, k_schedule: Tuple[int, ...],
             deferred: bool):
    """The descent to layer 0: the entry point scored (against the
    payload in filter space when ``deferred``, else by Dist.H), then
    each routing layer above 0 (which never filter tombstones: a deleted
    node is a fine waypoint). Returns (ep_d, ep) [B, ef] ascending, the
    Dist.H count [B] and the per-layer steps, top layer first."""
    return _drain(_descend_gen(db, queries, qprep, k_schedule, deferred))


def _descend_gen(db: PackedDB, queries, qprep,
                 k_schedule: Tuple[int, ...], deferred: bool):
    """``_descend`` as a generator (see ``_layer_gen``)."""
    cfg = db.cfg
    B = queries.shape[0]
    k_of = lambda l: k_schedule[min(l, len(k_schedule) - 1)]
    if deferred:
        ep = _entry_ids(db, B)
        pay = _gather_rows(db.low, ep)                  # [B, 1, P]
        if db.filter_kind == "pca":
            ep_d = ops.dist_l(pay, qprep)
        elif db.filter_kind == "cascade":
            ep_d = ops.pq_adc(pay, _cascade_lut(qprep, pay.shape[-1]))
        else:
            ep_d = ops.pq_adc(pay, qprep)
        dhe = torch.zeros((B,), dtype=torch.int32, device=db.device)
    else:
        ep_d, ep = _entry_start(db, queries)
        dhe = torch.ones((B,), dtype=torch.int32, device=db.device)
    steps = []
    for layer in range(len(db.layers) - 1, 0, -1):
        ep_d, ep, st, de = yield from _layer_gen(
            db, layer, queries, qprep, ep_d, ep,
            ef=cfg.ef_for_layer(layer), k=k_of(layer), deferred=deferred)
        steps.append(st)
        dhe = dhe + de
    return ep_d, ep, dhe, steps


def _search_batched_impl(db: PackedDB, queries, qprep, *, ef0: int,
                         k_schedule: Tuple[int, ...], deferred: bool,
                         rerank_mult: int, promote_mult: int,
                         final_rerank: bool = True):
    """Descend the upper routing layers, then run the layer-0 beam. The
    upper layers never filter tombstones (a deleted node is a fine
    descent waypoint); layer 0 does, iff the db carries a bitmap.

    Deferred mode runs the whole descent in filter space (the entry is
    scored against the payload, every layer traverses on filter
    distances, layer 0 keeps ``rerank_mult * ef0`` candidates) and
    finishes with a single batched Dist.H over the final list. The
    deferred CASCADE widens layer 0 further to ``promote_mult * ef0``
    PQ-space candidates and inserts the PCA promote stage (one batched
    ``dist_l`` over side-car rows, once per query) that trims them back
    to ``rerank_mult * ef0`` before the Dist.H pass. ``final_rerank=False``
    (deferred only) skips the promote stage and the re-rank and returns
    the WIDE filter-space list: the sharded path merges the shards'
    lists first and runs both once, globally."""
    return _drain(_search_gen(db, queries, qprep, ef0=ef0,
                              k_schedule=k_schedule, deferred=deferred,
                              rerank_mult=rerank_mult,
                              promote_mult=promote_mult,
                              final_rerank=final_rerank))


def _search_gen(db: PackedDB, queries, qprep, *, ef0: int,
                k_schedule: Tuple[int, ...], deferred: bool,
                rerank_mult: int, promote_mult: int,
                final_rerank: bool = True):
    """``_search_batched_impl`` as a generator: it yields just before
    each host read of a layer loop's ``done`` flags and returns the
    search's result."""
    k_of = lambda l: k_schedule[min(l, len(k_schedule) - 1)]
    deferred = deferred and db.filter_kind != "none"
    cascade = deferred and db.filter_kind == "cascade"
    ep_d, ep, dhe, steps = yield from _descend_gen(db, queries, qprep,
                                                   k_schedule, deferred)
    wide_mult = promote_mult if cascade else rerank_mult
    ef_run = ef0 * wide_mult if deferred else ef0
    fd, fi, st, de = yield from _layer_gen(
        db, 0, queries, qprep, ep_d, ep, ef=ef_run, k=k_of(0),
        filter_deleted=db.deleted is not None, deferred=deferred)
    steps.append(st)
    dhe = dhe + de
    if deferred and final_rerank:
        if cascade:
            # promote stage: ONE batched PCA score over side-car rows
            # trims the PQ-space pool to the Dist.H rerank pool
            pd, pi = _promote(db, qprep, fi)
            fd, fi = pd[:, :ef0 * rerank_mult], pi[:, :ef0 * rerank_mult]
        # the deferred high-dim re-rank: ONE batched Dist.H over the
        # final filter-space list, then a single sort back to ef0
        rd, ri, n_ok = _rerank(db, queries, fi)
        dhe = dhe + n_ok
        fd, fi = rd[:, :ef0], ri[:, :ef0]
    return fd, fi, torch.stack(steps), dhe


def _promote(db: PackedDB, qprep, fi):
    """The cascade's promote stage: PCA distances of the side-car rows of
    the filter-space list ``fi`` (-1 pads score INF), stably sorted."""
    ok = fi >= 0
    qpca = _cascade_qpca(qprep, db.low.shape[1])
    dm = torch.where(ok, ops.dist_l(_gather_rows(db.low2, fi), qpca), INF)
    return _rank_sort_with_payload(dm, torch.where(ok, fi, -1))


def _rerank(db: PackedDB, queries, fi):
    """The deferred re-rank: ONE batched Dist.H over the filter-space
    list ``fi`` (-1 pads score INF), stably sorted; with the count of
    Dist.H evaluations per row."""
    ok = fi >= 0
    dh = torch.where(ok, ops.dist_h(_gather_rows(db.high, fi), queries), INF)
    rd, ri = _rank_sort_with_payload(dh, torch.where(ok, fi, -1))
    return rd, ri, ok.sum(1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# slotted resumable search state — the continuous-batching substrate
# (serve/scheduler.py), the port of the reference's slotted programs.
#
# The synchronous path runs descent + layer 0 to completion for one batch;
# a query whose ``done`` latched early idles until the slowest query of
# its batch converges (the convoy). Here the layer-0 traversal state is a
# long-lived bank of S slots:
#
#   * ``_slot_step`` advances every live slot by up to ``quantum`` trips
#     of the SAME ``_layer_body`` the synchronous search runs, and returns
#     — the host then retires slots whose ``done`` latched and refills
#     them;
#   * ``_slot_admit`` descends fresh queries through the routing layers
#     and writes their layer-0 state into chosen slots (a fixed-width
#     scatter; pad rows carry a slot id >= S and land in a spare row that
#     nothing reads, so no admission syncs with the host);
#   * the per-slot ``ef_eff`` (mixed k) and ``budget`` (adaptive step
#     budgets) are data in the state — see ``_layer_body``.
#
# Every program is functional: it returns a new ``SlotState`` and never
# writes a tensor of the state it was given (the body's in-place visited
# update runs on a copy), so a state held by the caller stays as it was.
# The sharded twins take the stacked view of a ShardedDB
# (``core.distributed.stacked_db_view``) and the stacked [P, S, ...]
# state and run the SAME programs once over all P shards, the state
# viewed as [P * S, ...] shard-major, as the reference's ``vmap`` over
# the shards: each launch of the expand and fold kernels serves every
# shard, each shard descends from its own entry, the same admitted
# queries go into the same slots of every shard, the width ladder steps
# ``[:, :width]`` of every shard, and the slotted loop test is taken per
# shard (``_layer_body``). Every shard steps, dead or alive; the
# scheduler merges the disjoint per-shard lists at retirement.
# ``slot_cache_sizes`` counts the distinct (program, static arguments,
# shapes) keys each program has been called with: the counterpart of the
# reference's compiled-program caches, which steady-state churn must not
# grow.
# ---------------------------------------------------------------------------

_SLOT_FIELDS = ("C_d", "C_i", "F_d", "F_i", "V", "Cp", "done", "nsteps",
                "dhe", "q_high", "qprep", "ef_eff", "budget")


@dataclass
class SlotState:
    """The resumable layer-0 traversal state of S slots (leading dim S;
    the sharded bank prepends the shard dim P). Admission, budget
    escalation and epoch swaps change only data, never a shape. An
    EMPTY slot is ``done=True`` with ``budget=0`` and a -1/INF frontier:
    it latches at once and expands nothing."""
    C_d: torch.Tensor      # [S, CAP] sorted candidate frontier dists
    C_i: torch.Tensor      # [S, CAP] candidate ids (-1 pad)
    F_d: torch.Tensor      # [S, EF] sorted result dists
    F_i: torch.Tensor      # [S, EF] result ids (-1 pad)
    V: torch.Tensor        # [S, ceil(N/32)] visited bitmap words
    Cp: torch.Tensor       # [S, k] C_pca threshold heap
    done: torch.Tensor     # [S] bool, latched per slot
    nsteps: torch.Tensor   # [S] int32 expansion steps so far
    dhe: torch.Tensor      # [S] int32 Dist.H evaluations so far
    q_high: torch.Tensor   # [S, D] the resident queries
    qprep: torch.Tensor    # [S, ...] per-query filter prep
    ef_eff: torch.Tensor   # [S] int32 per-slot effective ef (<= EF)
    budget: torch.Tensor   # [S] int32 per-slot expansion-step budget

    def fields(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in _SLOT_FIELDS)

    def map(self, fn) -> "SlotState":
        """A state of ``fn(field)`` for every field."""
        return SlotState(*(fn(t) for t in self.fields()))


def _slot_zip(fn, *states: SlotState) -> SlotState:
    """A state of ``fn(a_field, b_field, ...)`` field by field."""
    return SlotState(*(fn(*ts) for ts in zip(*(s.fields()
                                                for s in states))))


def _slot_geometry(db, ef: int, deferred: bool = False
                   ) -> Tuple[int, int, int]:
    """(k, W, CAP) of the slotted layer-0 program, derived as
    ``search_layer_batched`` derives them. ``deferred`` selects the same
    effective layer-0 k the synchronous default does. ``db`` is a
    PackedDB or a ShardedDB."""
    cfg = db.cfg
    k = cfg.k_schedule_for(db.filter_kind, deferred)[0]
    W = cfg.expand_width
    M = (db.layers[0].adj if hasattr(db, "layers") else db.adj[0]).shape[-1]
    kk = W * M if db.filter_kind == "none" else W * k
    return k, W, max(ef + kk, 8)


def make_slot_state(db, n_slots: int, qprep_example, *, ef: int,
                    n_shards: Optional[int] = None,
                    deferred: bool = False) -> SlotState:
    """An all-empty slot bank on the db's device. ``ef`` is the compiled
    result width (a slot's ``ef_eff`` can only narrow it).
    ``qprep_example`` is any [b, ...] filter-prep array, read only for
    its trailing shape. ``n_shards`` prepends the shard dim to every
    field (``db`` is then a ShardedDB or its stacked view). ``deferred``
    must match the mode the slots will step in: it sizes the Cp heap to
    the same effective k the synchronous program keeps."""
    k, _, CAP = _slot_geometry(db, ef, deferred)
    N, D = db.high.shape[-2], db.high.shape[-1]
    nw = -(-N // 32)
    lead = () if n_shards is None else (n_shards,)
    shp = lambda *t: lead + (n_slots,) + t
    dev = db.high.device
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=dev)
    qp_trail = tuple(np.shape(qprep_example)[1:])
    i32, f32 = torch.int32, torch.float32
    return SlotState(
        C_d=full(shp(CAP), INF, f32), C_i=full(shp(CAP), -1, i32),
        F_d=full(shp(ef), INF, f32), F_i=full(shp(ef), -1, i32),
        V=full(shp(nw), 0, i32), Cp=full(shp(k), INF, f32),
        done=full(shp(), True, torch.bool), nsteps=full(shp(), 0, i32),
        dhe=full(shp(), 0, i32), q_high=full(shp(D), 0, f32),
        qprep=full(shp(*qp_trail), 0, f32),
        ef_eff=full(shp(), ef, i32), budget=full(shp(), 0, i32))


# the slotted programs, in ``slot_cache_sizes``' order
_SLOT_PROGRAMS = ("step", "admit", "step_sharded", "admit_sharded",
                  "step_prefix", "step_prefix_sharded", "admit_step",
                  "admit_step_sharded", "retire_rerank", "retire_promote")
_slot_keys = {name: set() for name in _SLOT_PROGRAMS}


def _shape_key(x):
    if x is None:
        return None
    if isinstance(x, SlotState):
        return tuple(_shape_key(t) for t in x.fields())
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, PackedDB):
        return (x.filter_kind, _shape_key(x.high), _shape_key(x.low),
                tuple(_shape_key(l.adj) + _shape_key(l.packed_low)
                      for l in x.layers),
                _shape_key(x.deleted), _shape_key(x.low2))
    # a ShardedDB
    return (x.filter_kind, _shape_key(x.high), _shape_key(x.low),
            tuple(map(_shape_key, x.adj)), tuple(map(_shape_key,
                                                    x.packed_low)),
            _shape_key(x.deleted), _shape_key(x.low2))


def _key(args, static: dict) -> tuple:
    """The key of one program call: its arguments' shapes and its
    static arguments."""
    return (tuple(map(_shape_key, args)), tuple(sorted(static.items())))


def _note(program: str, *args, **static) -> None:
    """Record one call of a slotted program under its key."""
    _slot_keys[program].add(_key(args, static))


def slot_cache_sizes() -> Tuple[int, ...]:
    """(step, admit, step_sharded, admit_sharded, step_prefix,
    step_prefix_sharded, admit_step, admit_step_sharded, retire_rerank,
    retire_promote): the distinct keys (static arguments and shapes)
    each slotted program has been called with — the scheduler's
    no-new-programs-under-churn assertions read these."""
    return tuple(len(_slot_keys[name]) for name in _SLOT_PROGRAMS)


def _scatter_rows(dst, ids, rows, dim: int = 0):
    """``dst`` with slots ``ids`` of its dim ``dim`` set to ``rows``; ids
    outside [0, S) are dropped (they land in a spare slot S that is cut
    off). ``dim`` 1: a stacked bank [P, S, ...] and ``rows`` [P, A, ...],
    the same slots of every shard."""
    S = dst.shape[dim]
    out = torch.cat([dst, dst.narrow(dim, 0, 1)], dim)
    out[(slice(None),) * dim + (ids,)] = rows.to(dst.dtype)
    return out.narrow(dim, 0, S)


def _slot_admit_impl(db: PackedDB, state: SlotState, q_new, qprep_new,
                     slot_ids, ef_eff_new, budget_new, *,
                     deferred: bool = False) -> SlotState:
    """Descend the admission batch through the routing layers (the same
    per-layer programs as ``_search_batched_impl``; in filter space when
    ``deferred``) and write the fresh layer-0 state into the chosen
    slots. The admission width is fixed: pad rows carry a slot id >= S
    and are dropped. On a stacked view the state is [P, S, ...] and the
    A queries descend every shard at once, as P * A shard-major rows,
    each shard from its own entry, into the same slots of every
    shard."""
    ef = state.F_d.shape[-1]
    k, _, CAP = _slot_geometry(db, ef, deferred)
    ks = db.cfg.k_schedule_for(db.filter_kind, deferred)
    deferred = deferred and db.filter_kind != "none"
    P = _n_stacked(db)
    if P:
        tile = lambda t: t.repeat(P, *([1] * (t.dim() - 1)))
        q_new, qprep_new, ef_eff_new, budget_new = map(
            tile, (q_new, qprep_new, ef_eff_new, budget_new))
    ep_d, ep, dhe, _ = _descend(db, q_new, qprep_new, ks, deferred)
    C_d, C_i, F_d, F_i, V, Cp = _layer_init(
        db, ep_d, ep, ef=ef, k=k, CAP=CAP,
        filter_deleted=db.deleted is not None)
    S = state.done.shape[-1]
    ids = slot_ids.long()
    ids = torch.where((ids >= 0) & (ids < S), ids, S)
    A = q_new.shape[0]
    dev = q_new.device
    new = SlotState(C_d, C_i, F_d, F_i, V, Cp,
                    torch.zeros((A,), dtype=torch.bool, device=dev),
                    torch.zeros((A,), dtype=torch.int32, device=dev), dhe,
                    q_new, qprep_new, ef_eff_new, budget_new)
    if P:
        new = new.map(lambda t: t.unflatten(0, (P, -1)))
    return _slot_zip(lambda d, r: _scatter_rows(d, ids, r, int(P > 0)),
                     state, new)


def _slot_step_impl(db: PackedDB, state: SlotState, *, quantum: int,
                    expand_width: int, deferred: bool = False) -> SlotState:
    """Advance every live slot by up to ``quantum`` trips of the layer-0
    body with the per-slot ``ef_eff`` / ``budget`` gates on. The loop
    ends early once no slot can progress (all done or budget-frozen),
    tested on the host every ``DONE_CHECK_EVERY`` trips; the trips in
    between are exact no-ops (see ``_layer_body``). ``deferred``
    traverses on filter distances: F then holds filter-space candidates
    and the scheduler re-ranks at retirement. On a stacked view the
    [P, S, ...] state steps as [P * S, ...] shard-major rows, one pass
    for all shards; the early exit then needs every shard's slots
    unable to progress (a shard that stopped earlier runs exact no-op
    trips meanwhile: its loop test ``go`` is its own)."""
    P = _n_stacked(db)
    if P:
        state = state.map(lambda t: t.flatten(0, 1))
    ef = state.F_d.shape[-1]
    k = state.Cp.shape[-1]
    body = _layer_body(db, 0, state.q_high, state.qprep, ef=ef, k=k,
                       W=expand_width, steps=0,
                       filter_deleted=db.deleted is not None,
                       deferred=deferred and db.filter_kind != "none",
                       ef_eff=state.ef_eff, budget=state.budget)
    st = (state.C_d, state.C_i, state.F_d, state.F_i, state.V.clone(),
          state.Cp, state.done, state.nsteps, state.dhe)
    for t in range(quantum):
        if t % DONE_CHECK_EVERY == 0 and \
                not bool((~st[6] & (st[7] < state.budget)).any()):
            break
        st = body(st)
    state = dataclasses.replace(state, **dict(zip(_SLOT_FIELDS[:9], st)))
    return state.map(lambda t: t.unflatten(0, (P, -1))) if P else state


def _slot_step_prefix_impl(db: PackedDB, state: SlotState, *, width: int,
                           quantum: int, expand_width: int,
                           deferred: bool = False) -> SlotState:
    """Step only the first ``width`` slots of the bank (the width
    ladder: slots are allocated low-first, so the scheduler steps the
    smallest prefix covering the highest live slot); on a stacked view
    the first ``width`` slots of every shard, ``[:, :width]``."""
    d = 1 if _n_stacked(db) else 0
    part = _slot_step_impl(db, state.map(lambda t: t.narrow(d, 0, width)),
                           quantum=quantum, expand_width=expand_width,
                           deferred=deferred)
    return _slot_zip(lambda f, p: torch.cat(
        [p, f.narrow(d, width, f.shape[d] - width)], d), state, part)


def _slot_admit_step_impl(db: PackedDB, state: SlotState, q_new, qprep_new,
                          slot_ids, ef_eff_new, budget_new, *, width: int,
                          quantum: int, expand_width: int,
                          deferred: bool = False) -> SlotState:
    """One tick's program: the admission, then the prefix step."""
    state = _slot_admit_impl(db, state, q_new, qprep_new, slot_ids,
                             ef_eff_new, budget_new, deferred=deferred)
    return _slot_step_prefix_impl(db, state, width=width, quantum=quantum,
                                  expand_width=expand_width,
                                  deferred=deferred)


def _stacked(db) -> PackedDB:
    """``db`` checked to be a stacked view: the sharded programs take
    ``core.distributed.stacked_db_view(sdb)``, as the reference's."""
    if not (isinstance(db, PackedDB) and _n_stacked(db)):
        raise TypeError("the sharded slotted programs take a stacked view "
                        "(core.distributed.stacked_db_view(sdb))")
    return db


def _slot_admit(db, state, q_new, qprep_new, slot_ids, ef_eff_new,
                budget_new, deferred=False):
    _note("admit", db, state, q_new, qprep_new, slot_ids, deferred=deferred)
    return _slot_admit_impl(db, state, q_new, qprep_new, slot_ids,
                            ef_eff_new, budget_new, deferred=deferred)


def _slot_step(db, state, quantum, expand_width, deferred=False):
    _note("step", db, state, quantum=quantum, W=expand_width,
          deferred=deferred)
    return _slot_step_impl(db, state, quantum=quantum,
                           expand_width=expand_width, deferred=deferred)


def _slot_admit_sharded(db, state, q_new, qprep_new, slot_ids, ef_eff_new,
                        budget_new, deferred=False):
    """Admission over a stacked view (``core.distributed.
    stacked_db_view``): each shard descends its own graph for the SAME
    queries into the SAME slots, all shards in one pass."""
    _note("admit_sharded", _stacked(db), state, q_new, qprep_new,
          slot_ids, deferred=deferred)
    return _slot_admit_impl(db, state, q_new, qprep_new, slot_ids,
                            ef_eff_new, budget_new, deferred=deferred)


def _slot_step_sharded(db, state, quantum, expand_width, deferred=False):
    _note("step_sharded", _stacked(db), state, quantum=quantum,
          W=expand_width, deferred=deferred)
    return _slot_step_impl(db, state, quantum=quantum,
                           expand_width=expand_width, deferred=deferred)


def _slot_step_prefix(db, state, width, quantum, expand_width,
                      deferred=False):
    _note("step_prefix", db, state, width=width, quantum=quantum,
          W=expand_width, deferred=deferred)
    return _slot_step_prefix_impl(db, state, width=width, quantum=quantum,
                                  expand_width=expand_width,
                                  deferred=deferred)


def _slot_step_prefix_sharded(db, state, width, quantum, expand_width,
                              deferred=False):
    _note("step_prefix_sharded", _stacked(db), state, width=width,
          quantum=quantum, W=expand_width, deferred=deferred)
    return _slot_step_prefix_impl(db, state, width=width, quantum=quantum,
                                  expand_width=expand_width,
                                  deferred=deferred)


def _slot_admit_step(db, state, q_new, qprep_new, slot_ids, ef_eff_new,
                     budget_new, width, quantum, expand_width,
                     deferred=False):
    _note("admit_step", db, state, q_new, qprep_new, slot_ids, width=width,
          quantum=quantum, W=expand_width, deferred=deferred)
    return _slot_admit_step_impl(db, state, q_new, qprep_new, slot_ids,
                                 ef_eff_new, budget_new, width=width,
                                 quantum=quantum, expand_width=expand_width,
                                 deferred=deferred)


def _slot_admit_step_sharded(db, state, q_new, qprep_new, slot_ids,
                             ef_eff_new, budget_new, width, quantum,
                             expand_width, deferred=False):
    _note("admit_step_sharded", _stacked(db), state, q_new, qprep_new,
          slot_ids, width=width, quantum=quantum, W=expand_width,
          deferred=deferred)
    return _slot_admit_step_impl(db, state, q_new, qprep_new, slot_ids,
                                 ef_eff_new, budget_new, width=width,
                                 quantum=quantum, expand_width=expand_width,
                                 deferred=deferred)


def _retire_rerank(db: PackedDB, queries, fi):
    """The scheduler's deferred Dist.H pass at retirement: the final
    block of the synchronous deferred program (``_rerank``) over a
    fixed-width batch of slots, non-retiring rows carrying ``fi = -1``.
    Returns (dists, ids, Dist.H count per row)."""
    _note("retire_rerank", db, queries, fi)
    return _rerank(db, queries, fi)


def _retire_promote(db: PackedDB, qprep, fi, n_keep):
    """The scheduler's cascade promote pass at retirement: PCA-score the
    side-car rows of the slots' PQ-space lists and keep each slot's best
    ``n_keep`` [S] (INF/-1 past them)."""
    _note("retire_promote", db, qprep, fi)
    pd, pi = _promote(db, qprep, fi)
    keep = torch.arange(pd.shape[1], device=pd.device)[None, :] \
        < n_keep[:, None]
    return torch.where(keep, pd, INF), torch.where(keep, pi, -1)
