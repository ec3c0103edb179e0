"""The port's ``distributed_search`` against ``repro.core.distributed``
in the cascade-deferred mode: bit-equal to the reference's
``shard_search_host`` on meshes (1, 2) and (2, 2) of "cpu" devices with
tombstones, every shard live and one dead, and at P = 1 to the
reference's ``distributed_search`` on a real one-device mesh. Cases of
tests/test_torch_mesh.py (same fixture), kept in a file of their own so
that each file takes under half a minute on a CPU."""
import numpy as np
import jax
import jax.numpy as jnp

from repro.core import distributed as rdist
from repro_torch.core import distributed as tdist
from test_torch_distributed import MODES, _assert_stats_equal
from test_torch_mesh import (_cpu_mesh, _one_torch_thread,  # noqa: F401
                             _sharded, check_mesh_against_reference_host,
                             int_mesh)


def test_mesh_bit_equal_to_reference_host(int_mesh):
    check_mesh_against_reference_host(int_mesh, "cascade-deferred", 2, True)


def test_mesh_one_shard_bit_equal_to_reference_mesh(int_mesh):
    """P = 1: the reference's ``distributed_search`` on a real one-device
    ``jax.make_mesh((1, 1), ("data", "model"))``, tombstones in."""
    kind, deferred, rm = MODES["cascade-deferred"]
    _, _, q, _, _ = int_mesh
    tsdb, tfilt, rsdb, rfilt = _sharded(int_mesh, 1, kind, True, ref=True)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jd, ji, js = rdist.distributed_search(
        jmesh, rsdb, jnp.asarray(q), filt=rfilt, deferred=deferred,
        rerank_mult=rm, return_stats=True)
    td, ti, ts = tdist.distributed_search(
        _cpu_mesh(1, 1), tsdb, q, filt=tfilt, deferred=deferred,
        rerank_mult=rm, return_stats=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _assert_stats_equal(ts, js)
