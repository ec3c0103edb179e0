"""Shared numeric sentinels for the traversal path (a copy of
``repro/constants.py``: the port imports nothing of the JAX package).

``INF`` is a large FINITE f32, never ``float('inf')``: masked and padded
slots must round-trip between kernel calls bit-for-bit and never turn
arithmetic into NaNs. ``d < VALID_MAX`` marks a real entry."""
from __future__ import annotations

# "filtered out / empty slot" distance sentinel on the traversal path
INF = 3.4e38
# validity threshold: any distance >= VALID_MAX is a masked slot
VALID_MAX = 1e37
# attention-logit mask value
NEG_INF = -1e30
