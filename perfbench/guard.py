"""The import guard: the benchmark measures the PyTorch port alone, so no
module of JAX or of the JAX package ``repro`` may be loaded in a run.
Names are compared whole by their top-level part: ``repro_torch`` begins
with ``repro`` and passes."""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules) -> list:
    """The forbidden top-level names among the module names ``modules``
    (such as ``sys.modules``), sorted."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
