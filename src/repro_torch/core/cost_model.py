"""pHNSW processor cost model (paper Section V: Synopsys/CACTI/Ramulator
evaluation, re-derived analytically from instrumented search traces);
port of ``repro/core/cost_model.py``, pure float arithmetic.

Every constant below models the PAPER's 65 nm pHNSW processor and its
DDR4 / HBM1.0 memories. None of them is an H100 number: a QPS or energy
this module returns is the modeled processor's, never the card's.

Constants and their provenance:
  * 1 GHz clock, Table II cycle counts (kSort.L=7, Min.H=1, RMF=8,
    Visit&Raw=2, Move=1, JMP=1).
  * Dist.L: 16 distance lanes (Section IV-B3 "processing 16 data points
    simultaneously"), pipelined over d_low dims -> d_low cycles per
    16-point group.
  * Dist.H: sequential high-dim unit; 4 MACs/cycle (4B register lanes)
    -> dim/4 cycles per point.
  * Move overhead: the paper reports Move at up to 72.8% of executed
    instructions, i.e. 2.68 Moves per compute instruction, executed on
    TWO Move/BUS units -> 1.34 cycles of Move per compute cycle.
  * DDR4: 19.2 GB/s, 18.75 pJ/bit; HBM1.0: 128 GB/s, 7 pJ/bit
    (Section V-A). Random-access latency 45/40 ns (Ramulator DDR4-2400 /
    HBM tRC-class timings), 10 ns burst-setup overhead.
  * Core power 150 mW dynamic + 50 mW leakage (65 nm, 0.739 mm^2 class
    design) — energy = P * t; DRAM energy = bytes * pJ/bit. These two
    constants were chosen once so the DRAM energy share lands in the
    paper's reported bands (82-87% DDR4, 63-72% HBM) and then frozen;
    all RATIOS reported in benchmarks derive from measured traces, not
    from tuning.

Compute and DRAM time are modeled as non-overlapped (conservative): the
single-query processor blocks on DMA (Section IV-C dataflow), which is
also the paper's explanation for pHNSW-Sep's energy waste ("energy
consumed by other components waiting for data").
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.search_ref import SearchStats


@dataclass(frozen=True)
class DramConfig:
    name: str
    bandwidth_gbps: float      # GB/s
    pj_per_bit: float
    rand_latency_ns: float     # exposed per irregular access
    burst_overhead_ns: float   # per sequential burst

    def time_ns(self, st: SearchStats) -> float:
        seq = st.seq_bursts * self.burst_overhead_ns \
            + st.seq_bytes / self.bandwidth_gbps
        rand = st.rand_accesses * self.rand_latency_ns \
            + st.rand_bytes / self.bandwidth_gbps
        return seq + rand

    def energy_pj(self, st: SearchStats) -> float:
        return (st.seq_bytes + st.rand_bytes) * 8.0 * self.pj_per_bit


DDR4 = DramConfig("DDR4", 19.2, 18.75, 45.0, 10.0)
HBM = DramConfig("HBM", 128.0, 7.0, 40.0, 10.0)


@dataclass(frozen=True)
class ProcessorConfig:
    name: str = "phnsw"
    freq_ghz: float = 1.0
    dist_lanes: int = 16        # Dist.L parallel lanes
    ksort_cycles: int = 7       # Table II
    disth_macs_per_cycle: int = 4
    minh_cycles: int = 1
    visit_cycles: int = 2
    rmf_cycles: int = 8
    heap_cycles: int = 4        # C/F list update (register ops)
    move_per_compute: float = 2.68   # -> 72.8% Move share
    move_units: int = 2
    dyn_power_w: float = 0.150
    static_power_w: float = 0.050

    def compute_cycles(self, st: SearchStats, dim: int, d_low: int,
                       d_mid: int = 0) -> Dict:
        """``d_low`` is the per-point filter pipeline depth: d_low dims
        for the PCA filter, n_sub table lookups for PQ, the full dim
        for the identity bypass — pass ``FilterSpec.cost_dims`` (or use
        ``query_cost(..., filt=...)``) so the modeled compute stays
        honest across filters. ``d_mid`` prices the cascade's promote
        stage (``SearchStats.dist_mid`` evals, PCA-row depth =
        ``CascadeFilter.mid_cost_dims``) on the same 16-lane Dist.L
        unit — a separate term because the two stages run at different
        pipeline depths (ADC table lookups vs f32 dims)."""
        c = {}
        c["dist_l"] = math.ceil(st.dist_low / self.dist_lanes) * d_low
        if st.dist_mid:
            c["dist_m"] = math.ceil(st.dist_mid / self.dist_lanes) * d_mid
        c["ksort_l"] = st.ksort_calls * self.ksort_cycles
        c["dist_h"] = st.dist_high * math.ceil(dim / self.disth_macs_per_cycle)
        c["min_h"] = st.minh_calls * self.minh_cycles
        c["visit"] = st.visit_checks * self.visit_cycles
        c["rmf"] = st.evictions * self.rmf_cycles
        c["heap"] = st.f_updates * self.heap_cycles
        c["jmp"] = st.expansions
        compute = sum(c.values())
        c["move"] = compute * self.move_per_compute / self.move_units
        return c


PROCESSOR = ProcessorConfig()


@dataclass
class QueryCost:
    compute_ns: float
    dram_ns: float
    core_pj: float
    dram_pj: float
    breakdown: Dict[str, float]

    @property
    def total_ns(self) -> float:
        return self.compute_ns + self.dram_ns

    @property
    def total_pj(self) -> float:
        return self.core_pj + self.dram_pj

    @property
    def qps(self) -> float:
        return 1e9 / self.total_ns

    @property
    def energy_uj(self) -> float:
        return self.total_pj / 1e6

    @property
    def dram_energy_share(self) -> float:
        return self.dram_pj / max(self.total_pj, 1e-12)


def query_cost(st: SearchStats, *, n_queries: int, dim: int,
               d_low: Optional[int] = None, dram: DramConfig,
               proc: ProcessorConfig = PROCESSOR, filt=None,
               d_mid: Optional[int] = None) -> QueryCost:
    """Cost of ONE query given aggregate stats over ``n_queries``.

    The filter payload is priced generically: DRAM traffic arrives in
    the stats already weighted by the active filter's bytes/vector
    (``FilterSpec.bytes_per_vec`` — e.g. ``PQCodebook.bytes_per_vec``
    for PQ codes), and the filter-distance compute depth comes from
    ``filt.cost_dims`` when ``filt`` is given (``d_low`` is the
    PCA-era spelling, kept for the seed callers). Cascade stats carry
    a second stage (``dist_mid``, the PCA promote pass) priced at
    ``d_mid`` — taken from ``filt.mid_cost_dims`` when available,
    falling back to ``d_low`` so two-stage stats are never silently
    priced at depth zero."""
    if filt is not None:
        d_low = filt.cost_dims
        d_mid = getattr(filt, "mid_cost_dims", d_mid)
    if d_low is None:
        raise ValueError("query_cost needs d_low or filt")
    if d_mid is None:
        d_mid = d_low
    per = SearchStats(**{k: v / n_queries for k, v in st.as_dict().items()})
    cyc = proc.compute_cycles(per, dim, d_low, d_mid)
    compute_ns = sum(cyc.values()) / proc.freq_ghz
    dram_ns = dram.time_ns(per)
    total_s = (compute_ns + dram_ns) * 1e-9
    core_pj = (proc.dyn_power_w + proc.static_power_w) * total_s * 1e12
    dram_pj = dram.energy_pj(per)
    return QueryCost(compute_ns=compute_ns, dram_ns=dram_ns,
                     core_pj=core_pj, dram_pj=dram_pj,
                     breakdown={k: v / proc.freq_ghz for k, v in cyc.items()})


def hw_variant_stats(stats_hnsw: SearchStats, stats_packed: SearchStats,
                     stats_separate: SearchStats) -> Dict[str, SearchStats]:
    """The three processor variants of Table III."""
    return {"HNSW-Std": stats_hnsw, "pHNSW-Sep": stats_separate,
            "pHNSW": stats_packed}


def table3(stats: Dict[str, SearchStats], *, n_queries: int, dim: int,
           d_low: int) -> Dict[str, Dict[str, QueryCost]]:
    """{variant: {dram: QueryCost}} for the Table III grid."""
    out: Dict[str, Dict[str, QueryCost]] = {}
    for name, st in stats.items():
        out[name] = {}
        for dram in (DDR4, HBM):
            out[name][dram.name] = query_cost(
                st, n_queries=n_queries, dim=dim, d_low=d_low, dram=dram)
    return out
