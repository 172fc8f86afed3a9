"""The port's driver against the reference where their bits differ:
under the device engine the tie-jitter bits differ (``jax.random`` vs
``torch.Generator``), so the matchings and hence the partitions differ;
mutation always coarsens with the device engine, so runs with mutation
differ the same way.  As in the reference's own engine-parity test,
single-seed cuts on this 600-vertex instance spread by about +-20%, so
these checks compare cuts averaged over three seeds: their ratio must
lie within [0.8, 1.25].  (Split from ``tests/test_torch_impart.py``, so
that neither file holds a worker of the suite for more than 250 s.)
"""
import numpy as np

from port_parity import port_hg

from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
from repro_torch.core.impart import ImpartConfig, impart_partition

SLICE = dict(recombination_enabled=False, mutation_enabled=False,
             final_vcycles=0)


def test_impart_device_engine_cut_within_tolerance(small_hg, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "device")
    cuts = {"ref": [], "port": []}
    for seed in (11, 12, 13):
        kw = dict(k=4, eps=0.08, alpha=2, beta=2, seed=seed, lp_iters=4,
                  **SLICE)
        cuts["ref"].append(ref_impart(small_hg.structural_copy(),
                                      RefConfig(**kw)).cut)
        res = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                               device="cpu")
        cuts["port"].append(res.cut)
        # balanced, and the reported cut is the partition's
        bw = np.bincount(res.part, small_hg.vertex_weights, minlength=4)
        assert bw.max() <= 1.08 * np.ceil(small_hg.vertex_weights.sum() / 4)
    ratio = np.mean(cuts["port"]) / max(np.mean(cuts["ref"]), 1e-9)
    assert 0.8 <= ratio <= 1.25, cuts


def test_impart_default_config_cut_within_tolerance(small_hg):
    """The reference defaults with mutation on: cuts averaged over three
    seeds within [0.8, 1.25] of the reference's, every result balanced
    and the reported cut the partition's."""
    cuts = {"ref": [], "port": []}
    for seed in (1, 2, 3):
        kw = dict(k=4, eps=0.08, alpha=3, beta=2, seed=seed, lp_iters=4)
        want = ref_impart(small_hg.structural_copy(), RefConfig(**kw))
        got = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                               device="cpu")
        assert [t[2] for t in got.trace] == [t[2] for t in want.trace]
        assert any(t[2].startswith("mutate@") for t in got.trace)
        cuts["ref"].append(want.cut)
        cuts["port"].append(got.cut)
        bw = np.bincount(got.part, small_hg.vertex_weights, minlength=4)
        assert bw.max() <= 1.08 * np.ceil(small_hg.vertex_weights.sum() / 4)
        lam = [len(set(got.part[small_hg.pins[a:b]]))
               for a, b in zip(small_hg.edge_offsets[:-1],
                               small_hg.edge_offsets[1:])]
        assert got.cut == float(small_hg.edge_weights[np.asarray(lam) > 1]
                                .sum())
    ratio = np.mean(cuts["port"]) / max(np.mean(cuts["ref"]), 1e-9)
    assert 0.8 <= ratio <= 1.25, cuts
