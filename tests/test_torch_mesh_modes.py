"""The port's ``distributed_search`` against the reference's
``shard_search_host`` in the pq mode at P = 4 with tombstones and the
pca-deferred mode at P = 2 without, on meshes (1, P) and (2, P) of "cpu"
devices, with every shard live and with one dead. These are cases of
tests/test_torch_mesh.py (same fixture and check), kept in a file of
their own so that each file takes under half a minute on a CPU."""
import pytest

from test_torch_mesh import (_one_torch_thread,  # noqa: F401 (fixtures)
                             check_mesh_against_reference_host, int_mesh)

REF_CASES = [("pq", 4, True), ("pca-deferred", 2, False)]


@pytest.mark.parametrize("mode,P,tombs", REF_CASES)
def test_mesh_bit_equal_to_reference_host(int_mesh, mode, P, tombs):
    check_mesh_against_reference_host(int_mesh, mode, P, tombs)
