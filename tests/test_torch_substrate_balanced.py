"""Port parity of ``apps.placement`` at quality ``"balanced"``
(``impart_partition`` at alpha 3, beta 3, no final V-cycle).

The memetic operators draw jitter that the two packages do not share,
so the assignments differ.  Over three seeds each cut must lie within
[0.8, 1.25] of the reference's (the bar the parity tests hold
mutation's own jitter to), each assignment must meet the balance cap,
and the hash-placement cut, which depends on the seed alone, must be
equal.
"""
import numpy as np
import pytest

from port_parity import CPU, compact_rows

from repro.apps import placement as jplacement
from repro_torch.apps import placement

EPS = 0.10


def _host_cut(rows, part):
    """Queries whose distinct rows span more than one shard."""
    spans = [len(np.unique(part[np.unique(q)])) for q in rows
             if len(np.unique(q)) >= 2]
    return float(sum(s > 1 for s in spans))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_embedding_rows_balanced_within_band(seed):
    rows, n_rows = compact_rows(24)
    k = 4
    want = jplacement.partition_embedding_rows(rows, n_rows, k, eps=EPS,
                                               seed=seed)
    got = placement.partition_embedding_rows(rows, n_rows, k, eps=EPS,
                                             seed=seed, device=CPU)
    assert 0.8 * want.cut <= got.cut <= 1.25 * want.cut, (got.cut, want.cut)
    assert got.random_cut == want.random_cut
    assert got.reduction > 0
    assert got.cut == _host_cut(rows, got.assignment)
    part = got.assignment
    assert part.shape == (n_rows,) and part.min() >= 0 and part.max() < k
    loads = np.bincount(part, minlength=k)
    assert loads.max() <= (1 + EPS) * np.ceil(n_rows / k)
