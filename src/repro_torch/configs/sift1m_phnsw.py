"""The paper's own experiment config: SIFT1M, six-layer HNSW graph,
PCA 128 -> 15, per-layer k schedule (16, 8, 3, 3, 3, 3), recall@10 target
0.92 (Section III-B / V-A)."""
from repro_torch.configs.base import PHNSWConfig

CONFIG = PHNSWConfig(
    name="sift1m",
    n_points=1_000_000,
    dim=128,
    d_low=15,
    n_layers=6,
    M=16,
    M0=32,
    ef_upper=1,
    ef0=10,
    k_schedule=(16, 8, 3, 3, 3, 3),
    ef_construction=100,
    recall_at=10,
)

# Scaled-down variant used by CPU tests and benchmarks in this container
# (construction of the full 1M graph is minutes of numpy time; the scaled
# config preserves dims/degrees/k-schedule so algorithmic ratios hold).
SMALL = CONFIG_SMALL = PHNSWConfig(
    name="sift50k",
    n_points=50_000,
    dim=128,
    d_low=15,
    n_layers=6,
    M=16,
    M0=32,
    ef_upper=1,
    ef0=10,
    k_schedule=(16, 8, 3, 3, 3, 3),
    ef_construction=60,
    recall_at=10,
)
