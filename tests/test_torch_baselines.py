"""Port parity of the scalar refinement tier, the baselines and the
partition CLI.

Bit for bit at the same seeds: the baselines coarsen with the copied
numpy coarsener, refine one partition at a time with the scalar LP and
FM tiers (whose trajectories follow the reference's tie-breaks on
integer weights), and their V-cycles run under host coarsening, the
CPU's default engine in both packages.
"""
import sys

import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays, port_hg

from repro.core import baselines as jbaselines
from repro.core import metrics as jmetrics
from repro.core import refine as jrefine
from repro.data.hypergraphs import ispd_like as ref_ispd_like
from repro.launch import partition as jpartition
from repro_torch.core import baselines, metrics, refine
from repro_torch.launch import partition


def _part(hg, k, seed):
    rng = np.random.default_rng(seed)
    return jrefine.rebalance(hg.vertex_weights,
                             rng.integers(0, k, hg.n).astype(np.int32), k,
                             0.08)


@pytest.mark.parametrize("k", [4, 40])
def test_scalar_refine_bit_equal(k, small_hg):
    """lp_round, lp_refine, fm_refine and refine of one partition (the
    one-member gain dispatch on the LP side)."""
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    part = _part(small_hg, k, seed=k)
    padded = np.zeros(hga.n_pad, np.int32)
    padded[: small_hg.n] = part
    cap = jmetrics.balance_cap(hga.total_weight, k, 0.08)
    want = jrefine.lp_round(hga, padded, k, cap, np.float32(0.25))
    got = refine.lp_round(ph, torch.from_numpy(padded), k,
                          metrics.balance_cap(ph.total_weight, k, 0.08), 0.25)
    assert_bit_equal(got, want, "lp_round")
    for fn in ("lp_refine", "fm_refine", "refine"):
        kw = dict(max_iters=4) if fn == "lp_refine" else {}
        want_p, want_c = getattr(jrefine, fn)(hga, part, k, 0.08, **kw)
        got_p, got_c = getattr(refine, fn)(ph, part, k, 0.08, **kw)
        assert got_c == want_c, fn
        assert_bit_equal(got_p, want_p, fn)


def test_edge_weight_override_bit_equal(small_hg):
    """A shared bias of the gains (``edge_weight_override``) in the scalar
    and the population LP tier; cuts stay on the true weights."""
    k = 4
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    ewo = np.zeros(hga.m_pad, np.float32)
    ewo[: small_hg.m] = 1 + np.arange(small_hg.m) % 4
    part = _part(small_hg, k, seed=9)
    want_p, want_c = jrefine.lp_refine(hga, part, k, 0.08, max_iters=4,
                                       edge_weight_override=ewo)
    got_p, got_c = refine.lp_refine(ph, part, k, 0.08, max_iters=4,
                                    edge_weight_override=ewo)
    assert got_c == want_c
    assert_bit_equal(got_p, want_p)
    parts = np.stack([part, _part(small_hg, k, seed=10)])
    want_p, want_c = jrefine.lp_refine_population(
        hga, parts, k, 0.08, max_iters=4, edge_weight_override=ewo,
        shard="off")
    got_p, got_c = refine.lp_refine_population(
        ph, parts, k, 0.08, max_iters=4, edge_weight_override=ewo)
    assert_bit_equal(got_c, want_c)
    assert_bit_equal(got_p, want_p)


def test_multilevel_partition_bit_equal(small_hg):
    want = jbaselines.multilevel_partition(small_hg.structural_copy(), 4,
                                           0.08, seed=2, n_vcycles=1)
    got = baselines.multilevel_partition(port_hg(small_hg), 4, 0.08, seed=2,
                                         n_vcycles=1, device=CPU)
    assert got.cut == want.cut
    assert got.trace == want.trace
    assert_bit_equal(got.part, want.part)
    best = baselines.multilevel_best_of(port_hg(small_hg), 4, 0.08, seed=1,
                                        repetitions=2, device=CPU)
    want = jbaselines.multilevel_best_of(small_hg.structural_copy(), 4, 0.08,
                                         seed=1, repetitions=2)
    assert best.cut == want.cut
    assert_bit_equal(best.part, want.part)


def test_external_memetic_bit_equal(small_hg):
    kw = dict(seed=3, population=3, generations=3)
    want = jbaselines.external_memetic(small_hg.structural_copy(), 4, 0.08,
                                       **kw)
    got = baselines.external_memetic(port_hg(small_hg), 4, 0.08, device=CPU,
                                     **kw)
    assert got.cut == want.cut
    assert got.trace == want.trace
    assert_bit_equal(got.part, want.part)


def _cut_line(out: str) -> str:
    return [ln for ln in out.splitlines() if " cut=" in ln][-1].split(
        " balanced")[0]


@pytest.mark.parametrize("method", ["multilevel", "ext_memetic"])
def test_cli_prints_reference_cut(method, tmp_path, capsys, monkeypatch):
    args = ["--design", "ibm01_like", "--k", "4", "--scale", "0.02",
            "--method", method, "--alpha", "2", "--beta", "2", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["partition"] + args)
    jpartition.main()
    want = _cut_line(capsys.readouterr().out)
    out = tmp_path / "part.npy"
    partition.main(args + ["--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert _cut_line(text) == want
    assert "balanced=True" in text
    # the saved assignment is the reported partition
    hg = ref_ispd_like("ibm01_like", scale=0.02)
    hga = hg.arrays()
    part = np.load(out)
    cut = float(jmetrics.cutsize_jit(hga, jrefine.pad_part(part, hga.n_pad),
                                     4))
    assert f"cut={cut:.0f}" in want


def test_cli_impart_on_cpu_and_no_fallback(capsys):
    partition.main(["--design", "ibm01_like", "--k", "4", "--scale", "0.02",
                    "--alpha", "2", "--beta", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "1 recomb, 1 mutations" in text and "balanced=True" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            partition.main(["--design", "ibm01_like", "--scale", "0.02"])
