"""The comparison that decides ``correct``.

Every call of the measured window answered some rows of one pool of
queries. Each answer row is held to what the configuration states:

* ``bad_rows``: rows that are not k distinct ids of the index in
  ascending order of finite distance, and rows missing from a call;
* ``dist_gap``: the widest gap between a returned distance and the exact
  squared L2 distance of the returned id, worked out here in float64
  from the raw vectors, as a share of that distance plus 1 (distances
  run to hundreds at SIFT's scale, so the 1 only guards a zero);
* ``recall10_min``: the lowest over the calls of the mean recall@10
  against ``exact_knn`` (the first 10 ids returned, in every cell),
  held to the configuration's ``recall10_min``.

``recall10`` (the end-to-end metric) is the mean over the calls."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.knn import exact_knn

# The widest dist_gap allowed, set between its readings (PERF.md § 2):
# the port's sound runs read about 2e-7 (float32 sums of 128 squares),
# the TF32 control above 0.26.
DIST_GAP_LIMIT = 1e-3
RECALL_AT = 10


def judge(x: np.ndarray, pool: np.ndarray, calls, records, *, k: int,
          recall10_min: float, failed: int, device,
          block: int = 8192) -> dict:
    """``records``: one (r, dists [B, >= k], ids [B, >= k]) per call, whose
    row j answers ``pool[calls[r][j]]``. ``failed``: queries of calls
    that raised. Returns the readings, the checks (value, limit, op) and
    ``correct``."""
    N = len(x)
    _, gt = exact_knn(x, pool, RECALL_AT, device=device)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=device)
    pool64 = torch.as_tensor(pool, dtype=torch.float64, device=device)
    recalls, gap, bad = [], 0.0, 0
    for r, fd, fi in records:
        rows = torch.as_tensor(calls[r], device=device)
        B = len(rows)
        if fi.ndim != 2 or fi.shape[1] < k or len(fi) != B \
                or fd.shape != fi.shape:
            bad += B
            recalls.append(0.0)
            continue
        ids = torch.as_tensor(np.asarray(fi[:, :k], np.int64), device=device)
        d = torch.as_tensor(np.asarray(fd[:, :k], np.float64), device=device)
        ok = (ids >= 0) & (ids < N)
        s = ids.sort(1).values
        dup = (s[:, 1:] == s[:, :-1]).any(1)
        unsorted = (d[:, 1:] < d[:, :-1]).any(1)
        bad += int((~ok.all(1) | dup | unsorted
                    | ~torch.isfinite(d).all(1)).sum())
        for a in range(0, B, block):
            sl = slice(a, min(a + block, B))
            ref = ((x64[ids[sl].clamp(0, N - 1)]
                    - pool64[rows[sl]][:, None]) ** 2).sum(-1)
            g = torch.where(ok[sl], (d[sl] - ref).abs() / (ref + 1.0), 0.0)
            gap = max(gap, float(torch.nan_to_num(g, nan=np.inf).max()))
        got = ids[:, :RECALL_AT]
        hits = (got[:, :, None] == gt[rows][:, None, :]).any(-1).sum()
        recalls.append(float(hits) / (B * RECALL_AT))
    checks = {
        "failed": {"value": failed, "limit": 0, "op": "<="},
        "bad_rows": {"value": bad, "limit": 0, "op": "<="},
        "dist_gap": {"value": gap, "limit": DIST_GAP_LIMIT, "op": "<="},
        "recall10_min": {"value": min(recalls) if recalls else 0.0,
                         "limit": recall10_min, "op": ">="},
    }
    held = all(c["value"] <= c["limit"] if c["op"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())
    return {"correct": bool(held and records),
            "recall10": float(np.mean(recalls)) if recalls else 0.0,
            "calls": len(records), "checks": checks}
