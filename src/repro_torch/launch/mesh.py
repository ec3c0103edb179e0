"""Production mesh construction (port of ``repro/launch/mesh.py``).

Functions, never module-level meshes, so that importing this module
touches no device. The reference's topology, axis names and shapes:

  single pod:  (data=16, model=16)          = 256 devices
  multi pod:   (pod=2, data=16, model=16)   = 512 devices

taken from the cards present (``core.distributed.make_mesh``); too few
raise, and the CPU never stands in for a missing card. A mesh of one
card repeated (``make_mesh(..., devices=["cuda:0"] * n)``) runs the
same program on one card.

The dry-run (``launch/dryrun.py``) needs no card, as the reference's
needs no TPU: ``make_abstract_production_mesh`` has the same shapes and
axis names, and each position is a "meta" device of its own index
("meta:0" ... "meta:255"). A tensor made there lies on plain "meta"
(torch drops the index), so nothing is allocated; the positions keep
their identities as the mesh's device names, which is what ``Sharded``
keys its blocks by: each position stores its own copy of a replicated
block, as on separate cards, and the dry-run counts what each would
hold."""
from __future__ import annotations

import numpy as np

from repro_torch.core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2) -> Mesh:
    if multi_pod:
        shape, axes = (n_pods, 16, 16), ("pod", "data", "model")
    else:
        shape, axes = (16, 16), ("data", "model")
    n = int(np.prod(shape))
    try:
        return make_mesh(shape, axes)
    except ValueError as e:
        raise RuntimeError(f"mesh {shape} needs {n} cards: {e}") from None


def make_host_mesh(devices=None) -> Mesh:
    """A (1, 1) ("data", "model") mesh: the first card, or
    ``devices[0]`` when the caller names it ("cpu" for the CPU)."""
    if devices is None:
        return make_mesh((1, 1), ("data", "model"))
    return make_mesh((1, 1), ("data", "model"), devices=list(devices)[:1])


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose positions are the "meta"
    devices "meta:0", "meta:1" ... in row-major order: distinct names,
    no memory."""
    n = int(np.prod(shape))
    return make_mesh(shape, axes,
                     devices=[f"meta:{i}" for i in range(n)])


def make_abstract_production_mesh(*, multi_pod: bool = False,
                                  n_pods: int = 2) -> Mesh:
    """``make_production_mesh``'s shape and axes on "meta" devices
    (``abstract_mesh``), for the dry-run."""
    if multi_pod:
        return abstract_mesh((n_pods, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))
