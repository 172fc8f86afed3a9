"""Port parity of ``apps.placement``, quality ``"fast"``, and
``halo_volume``.

``"fast"`` runs ``multilevel_partition``: host coarsening and the
scalar refinement tier, which follow the reference's tie-breaks on
integer weights, so the assignment, the cut, the hash-placement cut and
the reduction must equal the reference's bit for bit (as
``tests/test_torch_baselines.py`` holds ``multilevel_partition``).
``place_experts`` always runs ``"fast"``.
"""
import numpy as np
import pytest

from port_parity import CPU, assert_bit_equal, compact_rows

from repro.apps import placement as jplacement
from repro.data import graphs as jgraphs
from repro_torch.apps import placement


def _assert_same(got, want):
    assert_bit_equal(got.assignment, want.assignment, "assignment")
    assert got.cut == want.cut
    assert got.random_cut == want.random_cut
    assert got.reduction == want.reduction
    assert got.reduction > 0


def test_graph_for_mesh_fast_bit_equal():
    ei = jgraphs.power_law_graph(300, 1200, seed=1)
    kw = dict(eps=0.06, seed=0, quality="fast")
    want = jplacement.partition_graph_for_mesh(ei, 300, 4, **kw)
    got = placement.partition_graph_for_mesh(ei, 300, 4, device=CPU, **kw)
    _assert_same(got, want)
    for feat_bytes in (4, 280):
        assert placement.halo_volume(ei, got.assignment, feat_bytes) == \
            jplacement.halo_volume(ei, want.assignment, feat_bytes)
    rng = np.random.default_rng(1)
    rand = rng.integers(0, 4, 300).astype(np.int32)
    assert placement.halo_volume(ei, rand, 280) == \
        jplacement.halo_volume(ei, rand, 280)
    assert placement.halo_volume(ei, got.assignment, 280) < \
        placement.halo_volume(ei, rand, 280)


def test_embedding_rows_fast_bit_equal():
    rows, n_rows = compact_rows(64)
    kw = dict(eps=0.10, seed=1, quality="fast")
    want = jplacement.partition_embedding_rows(rows, n_rows, 8, **kw)
    got = placement.partition_embedding_rows(rows, n_rows, 8, device=CPU,
                                             **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("n_pods", [2, 4])
def test_place_experts_bit_equal(n_pods):
    """A seeded top-2 routing trace over 16 experts."""
    rng = np.random.default_rng(n_pods)
    trace = np.argsort(rng.random((400, 16)) * rng.zipf(2.0, 16), axis=1
                       )[:, -2:]
    want = jplacement.place_experts(trace, n_pods, seed=2)
    got = placement.place_experts(trace, n_pods, seed=2, device=CPU)
    _assert_same(got, want)
