"""Port parity of the kernels' plain versions and of the dispatcher.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); here those are held against the
reference's Pallas kernels run as the reference's own tests run them
(``interpret=True``).  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py`` and by the tests
marked ``cuda`` here, which skip without a card.

Tolerances: the gain assemblies (population and one-member) are
compared bit for bit on integer-valued tables (every f32 sum is exact in
any order).  The rating sums of non-integer values, scalar and batched,
are compared with rtol=1e-6: the Pallas kernel sums through a one-hot
matmul and the JAX oracle through XLA's segment-sum, the port in index
order, so the last bits may differ.  Integer-valued ratings are exact.
Connectivity is integer arithmetic and compared bit for bit; the cut of
real weights with rel 1e-5 (the reference's own bar), of integer
weights exactly; the embedding bag with 1e-5 in f32 and 2e-2 in bf16
(the port sums in f32 and rounds once, the reference rounds in bf16),
as in the reference's sweeps.
"""
import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.gain import (gain_gather_batch_pallas,
                                gain_gather_pallas,
                                gain_stream_batch_pallas,
                                gain_stream_pallas)
from repro.kernels import ops as jops
from repro.kernels.connectivity import connectivity_pallas, cutsize_pallas
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.rating import rating_scatter_pallas
from repro_torch.kernels import (build, connectivity, embedding_bag, gain,
                                 ops, rating, ref)

# (alpha, N, D, M, k): N off the 256-row block, degree-0 rows, k around
# the warp width, and the ``table`` widths of the main path (ibm01's
# D = 16 rows at k = 16) and k = 1
GAIN_SHAPES = [(1, 100, 8, 64, 2), (3, 300, 8, 200, 33),
               (3, 200, 16, 700, 64), (1, 257, 8, 130, 40),
               (2, 300, 16, 200, 16), (2, 130, 8, 90, 1)]


def _gain_inputs(alpha, n, d, m, k, seed, trailing=False):
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, m, (n, d)).astype(np.int32)
    inc[rng.random((n, d)) < 0.3] = -1
    inc[rng.random(n) < 0.1] = -1                       # degree-0 vertices
    if trailing:                  # valid ids first, as the layout builder
        inc = -np.sort(-inc, axis=1)
    bi = rng.integers(0, 5, (alpha, m, k)).astype(np.float32)
    wi = rng.integers(0, 5, (alpha, m)).astype(np.float32)
    return inc, bi, wi


@pytest.mark.parametrize("shape", GAIN_SHAPES)
def test_gain_gather_batch_ref_matches_pallas(shape):
    inc, bi, wi = _gain_inputs(*shape, seed=sum(shape))
    want = gain_gather_batch_pallas(jnp.asarray(inc), jnp.asarray(bi),
                                    jnp.asarray(wi), interpret=True)
    got = ref.gain_gather_batch_ref(torch.from_numpy(inc),
                                    torch.from_numpy(bi),
                                    torch.from_numpy(wi))
    assert_bit_equal(got, want)


@pytest.mark.parametrize("shape", GAIN_SHAPES)
def test_gain_stream_batch_ref_matches_pallas(shape):
    inc, bi, wi = _gain_inputs(*shape, seed=sum(shape) + 1)
    want = gain_stream_batch_pallas(jnp.asarray(inc), jnp.asarray(bi),
                                    jnp.asarray(wi), interpret=True)
    args = (torch.from_numpy(inc), torch.from_numpy(bi), torch.from_numpy(wi))
    assert_bit_equal(ref.gain_stream_batch_ref(*args), want)
    # a narrow edge tile (many partial sums) gives the same bits
    assert_bit_equal(ref.gain_stream_batch_ref(*args, block_m=32), want)


@pytest.mark.parametrize("c,s", [(512, 512), (3000, 700), (130, 1000),
                                 (4096, 64)])
def test_rating_ref_matches_pallas(c, s):
    rng = np.random.default_rng(c + s)
    segs = np.sort(rng.integers(0, s, c)).astype(np.int32)
    vals = rng.normal(size=c).astype(np.float32)
    nin = min(c // 8, 7)
    segs[:nin] = -1                      # invalid candidates are dropped
    vals[:nin] = 0.0
    want = rating_scatter_pallas(jnp.asarray(vals), jnp.asarray(segs), s,
                                 interpret=True)
    got = ref.rating_segment_sum_ref(torch.from_numpy(vals),
                                     torch.from_numpy(segs), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # integer-valued ratings: exact against the reference's oracle
    ivals = rng.integers(0, 9, c).astype(np.float32)
    want = jref.rating_segment_sum_ref(jnp.asarray(ivals), jnp.asarray(segs),
                                       s)
    got = ref.rating_segment_sum_ref(torch.from_numpy(ivals),
                                     torch.from_numpy(segs), s)
    assert_bit_equal(got, want)


def test_cpu_wrappers_run_plain_versions_without_launching():
    ops.reset_launch_counts()
    inc, bi, wi = (torch.from_numpy(a)
                   for a in _gain_inputs(2, 50, 8, 40, 8, seed=0))
    assert_bit_equal(gain.gain_gather_batch(inc, bi, wi),
                     ref.gain_gather_batch_ref(inc, bi, wi))
    assert_bit_equal(gain.gain_stream_batch(inc, bi, wi),
                     ref.gain_stream_batch_ref(inc, bi, wi))
    segs = torch.tensor([-1, 0, 0, 2, 2, 2], dtype=torch.int32)
    vals = torch.arange(6, dtype=torch.float32)
    assert rating.rating_segment_sum(vals, segs, 4).tolist() == \
        [3.0, 0.0, 12.0, 0.0]
    assert rating.rating_segment_sum_batch(
        torch.stack([vals, 2 * vals]), segs, 4).tolist() == \
        [[3.0, 0.0, 12.0, 0.0], [6.0, 0.0, 24.0, 0.0]]
    assert_bit_equal(gain.gain_gather(inc, bi[0], wi[0]),
                     ref.gain_gather_batch_ref(inc, bi, wi)[0])
    assert_bit_equal(gain.gain_stream(inc, bi[1], wi[1]),
                     ref.gain_stream_batch_ref(inc, bi, wi)[1])
    assert ops.launch_counts() == {
        "gain_table": 0, "gain_stream": 0, "rating_segment_sum": 0,
        "rating_segment_sum_batch": 0, "gain_table_one": 0,
        "gain_stream_one": 0, "connectivity": 0, "cutsize": 0,
        "embedding_bag": 0}


@pytest.mark.parametrize("forced", ["table", "stream", "segsum", "compact",
                                    "auto"])
def test_gain_routing(forced, monkeypatch):
    monkeypatch.setenv("REPRO_GAIN_PATH", forced)
    inc_cpu = torch.zeros((4, 8), dtype=torch.int32)
    for k in (2, 32, 33, 1024):
        auto_cpu = "segsum" if k <= 32 else "compact"
        if forced == "auto":
            assert ops.gain_path(1024, k, None) == auto_cpu
            assert ops.gain_path(1024, k, inc_cpu) == auto_cpu
        elif forced in ("segsum", "compact"):
            assert ops.gain_path(1024, k, inc_cpu) == forced
        else:
            # kernel paths need the layout; without it the XLA-style
            # paths take over
            assert ops.gain_path(1024, k, inc_cpu) == forced
            assert ops.gain_path(1024, k, None) == auto_cpu
    assert ops.gain_layout_enabled("cpu") == (forced in ("table", "stream"))
    assert ops.gain_layout_enabled("cuda") == (forced not in ("segsum",
                                                              "compact"))
    with pytest.raises(ValueError):
        ops.gain_assemble_batch(inc_cpu, torch.zeros(1, 1, 2),
                                torch.zeros(1, 1), "segsum")
    with pytest.raises(ValueError):
        ops.gain_assemble(inc_cpu, torch.zeros(1, 2), torch.zeros(1),
                          "compact")


def test_gain_routing_on_cuda_layout(monkeypatch):
    """Auto routing on a CUDA-resident layout is decided from the layout's
    device and k alone (a stand-in object plays the card's tensor)."""
    monkeypatch.delenv("REPRO_GAIN_PATH", raising=False)

    class FakeCuda:
        is_cuda = True
    assert ops.gain_path(1 << 20, 16, FakeCuda()) == "table"
    assert ops.gain_path(1 << 20, 32, FakeCuda()) == "table"
    assert ops.gain_path(1 << 20, 33, FakeCuda()) == "stream"
    assert ops.gain_path(1 << 20, 1024, FakeCuda()) == "stream"


def test_rating_routing(monkeypatch):
    segs = torch.tensor([0, 0, 1], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 4.0])
    for forced in ops.RATING_PATHS:
        monkeypatch.setenv("REPRO_RATING_PATH", forced)
        assert ops.rating_path(10 ** 7) == forced
        assert ops.rating_segment_sum(vals, segs, 2).tolist() == [3.0, 4.0]
        assert ops.rating_segment_sum_batch(
            torch.stack([vals, -vals]), segs, 2).tolist() == \
            [[3.0, 4.0], [-3.0, -4.0]]
    monkeypatch.setenv("REPRO_RATING_PATH", "bogus")
    with pytest.warns(UserWarning, match="REPRO_RATING_PATH"):
        assert ops.rating_path(10) == "kernel"
    monkeypatch.delenv("REPRO_RATING_PATH")
    # linear kernel: no size cut-off
    assert ops.rating_path(10 ** 9) == "kernel"


@pytest.mark.parametrize("shape", GAIN_SHAPES)
def test_gain_one_member_refs_match_jax(shape):
    """The one-member plain versions (#5/#6) against the JAX oracles and
    the one-member Pallas kernels in interpret mode, bit for bit."""
    inc, bi, wi = _gain_inputs(*shape, seed=sum(shape) + 2)
    args = (torch.from_numpy(inc), torch.from_numpy(bi[0]),
            torch.from_numpy(wi[0]))
    jargs = (jnp.asarray(inc), jnp.asarray(bi[0]), jnp.asarray(wi[0]))
    got = ref.gain_gather_ref(*args)
    assert_bit_equal(got, jref.gain_gather_ref(*jargs))
    assert_bit_equal(got, gain_gather_pallas(*jargs, interpret=True))
    got = ref.gain_stream_ref(*args)
    assert_bit_equal(got, jref.gain_stream_ref(*jargs))
    assert_bit_equal(got, gain_stream_pallas(*jargs, interpret=True))
    assert_bit_equal(ref.gain_stream_ref(*args, block_m=32), got)
    for path in ("table", "stream"):
        assert_bit_equal(ops.gain_assemble(*args, path), got)


@pytest.mark.parametrize("alpha,c,s", [(1, 512, 512), (3, 1000, 300),
                                       (5, 130, 1000), (3, 4099, 64)])
def test_rating_batch_ref_matches_jax(alpha, c, s):
    """The batched plain version (#4) against the JAX oracle: rtol 1e-6
    on real-valued rows, exact on integer rows; every row bit-equal to
    the scalar plain version."""
    rng = np.random.default_rng(alpha * c + s)
    segs = np.sort(rng.integers(0, s, c)).astype(np.int32)
    segs[: min(c // 8, 7)] = -1
    vals = rng.normal(size=(alpha, c)).astype(np.float32)
    segs[-c // 3:] = s - 1          # a long run of zeros, like the ghosts'
    vals[:, -c // 3:] = 0.0
    got = ref.rating_segment_sum_batch_ref(torch.from_numpy(vals),
                                           torch.from_numpy(segs), s)
    want = jref.rating_segment_sum_batch_ref(jnp.asarray(vals),
                                             jnp.asarray(segs), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for a in range(alpha):
        assert_bit_equal(got[a], ref.rating_segment_sum_ref(
            torch.from_numpy(vals[a]), torch.from_numpy(segs), s))
    ivals = rng.integers(0, 9, (alpha, c)).astype(np.float32)
    assert_bit_equal(
        ref.rating_segment_sum_batch_ref(torch.from_numpy(ivals),
                                         torch.from_numpy(segs), s),
        jref.rating_segment_sum_batch_ref(jnp.asarray(ivals),
                                          jnp.asarray(segs), s))


# --------------------------------------------------------------------------
# connectivity, cut size and embedding bag (#7-#9)
# --------------------------------------------------------------------------
def _pins_part(m, s, n, k, seed):
    rng = np.random.default_rng(seed)
    pins = rng.integers(-1, n, size=(m, s)).astype(np.int32)
    part = rng.integers(0, k, size=n).astype(np.int32)
    return rng, pins, part


# the reference's sweeps (tests/test_kernels.py), plus an odd edge count
@pytest.mark.parametrize("m,s,n,k", [
    (512, 8, 300, 2), (512, 16, 1000, 8), (1024, 32, 4096, 32),
    (512, 128, 512, 17), (130, 8, 300, 5)])
def test_connectivity_ref_matches_jax(m, s, n, k):
    _, pins, part = _pins_part(m, s, n, k, seed=m + s + k)
    jargs = (jnp.asarray(pins), jnp.asarray(part), k)
    got = ref.connectivity_ref(torch.from_numpy(pins),
                               torch.from_numpy(part), k)
    assert got.dtype == torch.int32
    assert_bit_equal(got, jref.connectivity_ref(*jargs))
    assert_bit_equal(got, connectivity_pallas(*jargs, interpret=True))
    assert_bit_equal(ops.connectivity(torch.from_numpy(pins),
                                      torch.from_numpy(part), k), got)


@pytest.mark.parametrize("m,s,n,k,block_m", [
    (512, 8, 256, 4, 512), (2048, 16, 2048, 16, 512), (512, 8, 256, 4, 256),
    (130, 8, 300, 5, 512)])
def test_cutsize_ref_matches_jax(m, s, n, k, block_m):
    rng, pins, part = _pins_part(m, s, n, k, seed=m * k)
    w = rng.random(m).astype(np.float32)
    args = (torch.from_numpy(pins), torch.from_numpy(part))
    jargs = (jnp.asarray(pins), jnp.asarray(part))
    got = ref.cutsize_ref(*args, torch.from_numpy(w), k)
    assert got.shape == () and got.dtype == torch.float32
    want = cutsize_pallas(*jargs, jnp.asarray(w), k, block_m=block_m,
                          interpret=True)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(got) == pytest.approx(
        float(jref.cutsize_ref(*jargs, jnp.asarray(w), k)), rel=1e-5)
    # integer weights: exact
    iw = rng.integers(0, 9, m).astype(np.float32)
    assert float(ref.cutsize_ref(*args, torch.from_numpy(iw), k)) == \
        float(jref.cutsize_ref(*jargs, jnp.asarray(iw), k))


@pytest.mark.parametrize("r,d,b,l,dtype,combiner", [
    (100, 16, 8, 4, "float32", "sum"),
    (1000, 64, 32, 1, "float32", "sum"),
    (500, 32, 16, 8, "float32", "mean"),
    (100, 128, 8, 2, "bfloat16", "sum"),
    (300, 36, 7, 26, "bfloat16", "mean")])
def test_embedding_bag_ref_matches_jax(r, d, b, l, dtype, combiner):
    rng = np.random.default_rng(r + b)
    table32 = rng.normal(size=(r, d)).astype(np.float32)
    idx = rng.integers(-1, r, size=(b, l)).astype(np.int32)
    jtable = jnp.asarray(table32, getattr(jnp, dtype))
    table = torch.from_numpy(table32).to(getattr(torch, dtype))
    got = ref.embedding_bag_ref(table, torch.from_numpy(idx), combiner)
    assert got.dtype == table.dtype and got.shape == (b, d)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jref.embedding_bag_ref(jtable, jnp.asarray(idx), combiner),
                 embedding_bag_pallas(jtable, jnp.asarray(idx),
                                      combiner=combiner, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    assert torch.equal(ops.embedding_bag(table, torch.from_numpy(idx),
                                         combiner), got)
    with pytest.raises(ValueError, match="combiner"):
        ops.embedding_bag(table, torch.from_numpy(idx), "max")


@pytest.mark.parametrize("maker,design,scale", [
    ("ispd_like", "ibm01_like", 0.05), ("titan_like", "sparcT1_core_like",
                                        0.02)])
def test_layout_converters_byte_equal(maker, design, scale):
    from repro.data import hypergraphs as jdata
    from repro_torch.data import hypergraphs as tdata
    from port_parity import port_hg
    hg = getattr(jdata, maker)(design, scale=scale)
    phg = getattr(tdata, maker)(design, scale=scale)
    for kw in ({}, dict(block_m=128, lane_pad=16)):
        want = jops.edge_pin_matrix(hg, **kw)
        got = ops.edge_pin_matrix(phg, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    want = jops.vertex_incidence_matrix(hg)
    got = ops.vertex_incidence_matrix(port_hg(hg))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_connectivity_routing_by_k(monkeypatch):
    """k <= KERNEL_MAX_K goes to the kernel wrappers, larger k to the
    plain versions, as the reference routes; ``use_kernel=False`` always
    takes the plain versions."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(connectivity, "connectivity",
                        spy("connectivity", connectivity.connectivity))
    monkeypatch.setattr(connectivity, "cutsize",
                        spy("cutsize", connectivity.cutsize))
    for k, routed in ((32, True), (33, False), (64, False)):
        _, pins, part = _pins_part(300, 8, 200, k, seed=k)
        pins_t, part_t = torch.from_numpy(pins), torch.from_numpy(part)
        w = torch.ones(300)
        calls.clear()
        lam = ops.connectivity(pins_t, part_t, k)
        cut = ops.cutsize(pins_t, part_t, w, k)
        assert calls == (["connectivity", "cutsize"] if routed else [])
        assert_bit_equal(lam, jref.connectivity_ref(
            jnp.asarray(pins), jnp.asarray(part), k))
        assert float(cut) == float((lam > 1).sum())
        calls.clear()
        ops.connectivity(pins_t, part_t, k, use_kernel=False)
        ops.cutsize(pins_t, part_t, w, k, use_kernel=False)
        assert calls == []


def test_new_cpu_wrappers_run_plain_versions_without_launching():
    ops.reset_launch_counts()
    _, pins, part = _pins_part(100, 8, 50, 4, seed=1)
    pins_t, part_t = torch.from_numpy(pins), torch.from_numpy(part)
    w = torch.arange(100, dtype=torch.float32)
    assert_bit_equal(connectivity.connectivity(pins_t, part_t, 4),
                     ref.connectivity_ref(pins_t, part_t, 4))
    assert torch.equal(connectivity.cutsize(pins_t, part_t, w, 4),
                       ref.cutsize_ref(pins_t, part_t, w, 4))
    table = torch.randn(20, 8)
    idx = torch.tensor([[0, -1, 19], [3, 3, -1]], dtype=torch.int32)
    assert torch.equal(embedding_bag.embedding_bag(table, idx, "mean"),
                       ref.embedding_bag_ref(table, idx, "mean"))
    assert set(ops.launch_counts().values()) == {0}


def test_gain_ops_use_kernel_flag():
    """``ops.gain_gather``/``gain_gather_batch``/``edge_terms`` against the
    reference's ops, with and without the kernel."""
    inc, bi, wi = _gain_inputs(3, 120, 8, 90, 40, seed=5)
    args = (torch.from_numpy(inc), torch.from_numpy(bi),
            torch.from_numpy(wi))
    want = jops.gain_gather_batch(jnp.asarray(inc), jnp.asarray(bi),
                                  jnp.asarray(wi), use_kernel=False)
    for use_kernel in (True, False):
        assert_bit_equal(ops.gain_gather_batch(*args, use_kernel=use_kernel),
                         want)
        assert_bit_equal(ops.gain_gather(args[0], args[1][1], args[2][1],
                                         use_kernel=use_kernel), want[1])
    rng = np.random.default_rng(2)
    phi = rng.integers(0, 4, (50, 6)).astype(np.int32)
    sizes = rng.integers(0, 5, 50).astype(np.int32)
    w = rng.integers(1, 4, 50).astype(np.float32)
    got = ops.edge_terms(torch.from_numpy(phi), torch.from_numpy(sizes),
                         torch.from_numpy(w))
    wanted = jops.edge_terms(jnp.asarray(phi), jnp.asarray(sizes),
                             jnp.asarray(w))
    for g, x in zip(got, wanted):
        assert_bit_equal(g, x)


@pytest.fixture
def card():
    """The CUDA device, or a skip that says what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    try:
        build.nvcc()
    except RuntimeError as err:
        pytest.skip(str(err))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,n,k", [(130, 8, 300, 5), (50_000, 64, 51_000,
                                                        32)])
def test_connectivity_kernels_on_card(card, m, s, n, k):
    rng, pins, part = _pins_part(m, s, n, k, seed=m)
    pins_t, part_t = (torch.from_numpy(x).to(card) for x in (pins, part))
    assert_bit_equal(connectivity.connectivity(pins_t, part_t, k),
                     ref.connectivity_ref(pins_t, part_t, k))
    iw = torch.from_numpy(rng.integers(0, 9, m).astype(np.float32)).to(card)
    assert torch.equal(connectivity.cutsize(pins_t, part_t, iw, k),
                       ref.cutsize_ref(pins_t, part_t, iw, k))
    w = torch.from_numpy(rng.random(m).astype(np.float32)).to(card)
    got = connectivity.cutsize(pins_t, part_t, w, k)
    assert torch.equal(got, connectivity.cutsize(pins_t, part_t, w, k))
    assert float(got) == pytest.approx(
        float(ref.cutsize_ref(pins_t, part_t, w, k)), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,combiner", [("float32", "sum"),
                                            ("float32", "mean"),
                                            ("bfloat16", "sum")])
def test_embedding_bag_kernel_on_card(card, dtype, combiner):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(1000, 128)).astype(
        np.float32)).to(card, getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(-1, 1000, (333, 26)).astype(
        np.int32)).to(card)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        embedding_bag.embedding_bag(table, idx, combiner).float(),
        ref.embedding_bag_ref(table, idx, combiner).float(),
        rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# operand checks of the wrappers and the sorted pin edges of the
# fixed-order sums (host side, no card)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["dtype", "segs dtype", "shape", "device",
                                  "layout", "segments"])
def test_rating_operand_validation(case):
    """``rating._checked``, which runs before every launch, refuses what
    the kernel does not take (a CUDA tensor never reaches a plain
    version, so a wrong operand must raise)."""
    vals = torch.zeros((2, 10))
    segs = torch.zeros(10, dtype=torch.int32)
    assert rating._checked(vals, segs, 3) == (2, 10)
    bad = {"dtype": (vals.double(), segs, 3),
           "segs dtype": (vals, segs.long(), 3),
           "shape": (vals, segs[:9], 3),
           "device": (vals, segs.to("meta"), 3),
           "layout": (torch.zeros((10, 2)).t(), segs, 3),
           "segments": (vals, segs, -1)}[case]
    with pytest.raises(ValueError):
        rating._checked(*bad)


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "layout"])
def test_gain_operand_validation(case):
    """``gain._checked`` (both entries) refuses what the kernels do not
    take."""
    inc = torch.zeros((5, 4), dtype=torch.int32)
    bi, wi = torch.zeros((2, 7, 3)), torch.zeros((2, 7))
    assert gain._checked(inc, bi, wi) == (2, 5, 4, 7, 3)
    bad = {"dtype": (inc.long(), bi, wi),
           "shape": (inc, bi, wi[:, :6]),
           "device": (inc, bi, wi.to("meta")),
           "layout": (inc, torch.zeros((2, 3, 7)).transpose(1, 2), wi)}[case]
    with pytest.raises(ValueError):
        gain._checked(*bad)


def test_sorted_pin_edges_match_numpy():
    """``metrics.sorted_pin_edges``: the pins' edge ids in the stable
    vertex order of ``pins_by_vertex``, as numpy sorts them, so a gather
    through it gives the pin-order rows permuted into vertex order."""
    from repro_torch.core import metrics
    from repro_torch.data.hypergraphs import _modular_netlist
    hga = _modular_netlist(300, 400, seed=3, n_modules=4, p_local=0.8,
                           fanout_tail=1.5).arrays(device="cpu")
    pv, pe = hga.pin_vertex.numpy(), hga.pin_edge.numpy()
    order = np.argsort(pv, kind="stable")
    assert_bit_equal(metrics.sorted_pin_edges(hga), pe[order])
    got_order, vertex = metrics.pins_by_vertex(hga)
    assert_bit_equal(got_order, order)
    assert_bit_equal(vertex, pv[order])
    rows = torch.from_numpy(np.random.default_rng(4).random(
        (3, hga.m_pad)).astype(np.float32))
    assert_bit_equal(rows[:, metrics.sorted_pin_edges(hga)],
                     rows[:, hga.pin_edge.long()][:, order])


# --------------------------------------------------------------------------
# the redesigned kernels on the card (#2-#6): skip without one
# --------------------------------------------------------------------------
def _rating_card_case(label):
    """(segs, vals, S, exact) of the rating kernels' odd shapes: every
    segment of length 1, a run longer than a tile (integer values, so
    any order is exact), every id dropped, C = 1 and off the warp width,
    and the FM step's 119 rows."""
    rng = np.random.default_rng(len(label))

    def real(alpha, c):
        return (rng.random((alpha, c)) + 0.1).astype(np.float32)

    if label == "length 1":
        return np.arange(3001, dtype=np.int32), real(3, 3001), 3001, False
    if label == "long run":
        segs = np.concatenate([np.sort(rng.integers(0, 40, 900)),
                               np.full(40_000, 40),
                               np.sort(rng.integers(41, 90, 1001))])
        return (segs.astype(np.int32),
                rng.integers(0, 4, (2, segs.size)).astype(np.float32), 90,
                True)
    if label == "ids below 0":
        return np.full(777, -1, np.int32), real(2, 777), 500, False
    if label == "ids >= S":
        return np.full(777, 900, np.int32), real(2, 777), 500, False
    if label == "C = 1":
        return np.full(1, 3, np.int32), real(3, 1), 10, False
    if label == "C = 1001":
        segs = np.sort(rng.integers(-5, 950, 1001)).astype(np.int32)
        return segs, real(4, 1001), 900, False
    segs = np.sort(rng.integers(0, 1024, 4097)).astype(np.int32)
    return segs, real(119, 4097), 1024, False


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["length 1", "long run", "ids below 0",
                                   "ids >= S", "C = 1", "C = 1001",
                                   "alpha 119"])
def test_rating_kernels_on_card(card, label):
    """#4 and #3 at odd shapes: rtol 1e-6 of the plain version (equal on
    integers), batch rows bit-equal to the scalar entry, reruns
    bit-equal."""
    segs, vals, s, exact = _rating_card_case(label)
    segs_t, vals_t = torch.from_numpy(segs).to(card), \
        torch.from_numpy(vals).to(card)
    got = rating.rating_segment_sum_batch(vals_t, segs_t, s)
    assert torch.equal(got, rating.rating_segment_sum_batch(vals_t, segs_t,
                                                            s))
    assert torch.equal(got, torch.stack([
        rating.rating_segment_sum(row, segs_t, s) for row in vals_t]))
    want = ref.rating_segment_sum_batch_ref(vals_t, segs_t, s)
    if exact:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,trailing", [
    ((3, 1001, 8, 700, 1), False), ((2, 999, 24, 513, 3), False),
    ((1, 777, 1, 300, 8), False), ((2, 601, 1, 400, 16), True),
    ((3, 1003, 16, 900, 16), True), ((2, 517, 24, 700, 31), False),
    ((3, 1000, 8, 700, 32), True), ((1, 300, 24, 513, 1024), False)])
def test_gain_table_kernel_on_card(card, shape, trailing):
    """#1 and #5 (entry ``table``): equal to the plain versions and to a
    rerun at k from 1 to 32 (and 1024, which ``REPRO_GAIN_PATH=table``
    may send there), D = 1, 8 and 24, N off every group and block size,
    trailing pads as the layout builder leaves them, pads mid-row and
    degree-0 rows."""
    inc, bi, wi = (torch.from_numpy(a).to(card) for a in _gain_inputs(
        *shape, seed=sum(shape), trailing=trailing))
    got = gain.gain_gather_batch(inc, bi, wi)
    assert torch.equal(got, ref.gain_gather_batch_ref(inc, bi, wi))
    assert torch.equal(got, gain.gain_gather_batch(inc, bi, wi))
    # the last member's tables, off the 16-byte alignment when M*k is odd
    one = gain.gain_gather(inc, bi[-1].contiguous(), wi[-1].contiguous())
    assert torch.equal(one, ref.gain_gather_ref(inc, bi[-1], wi[-1]))
    assert torch.equal(one, gain.gain_gather(inc, bi[-1].contiguous(),
                                             wi[-1].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,trailing", [
    ((3, 500, 1, 300, 64), False), ((3, 777, 16, 1500, 64), True),
    ((3, 300, 8, 200, 33), False), ((2, 600, 16, 900, 100), False),
    ((1, 300, 24, 513, 1024), False)])
def test_gain_stream_kernel_on_card(card, shape, trailing):
    """#2 and #6 (entry ``stream``): equal to the plain versions and to a
    rerun, with D = 1, trailing pads as the layout builder leaves them,
    pads mid-row, degree-0 rows and k from 33 to 1024."""
    inc, bi, wi = (torch.from_numpy(a).to(card) for a in _gain_inputs(
        *shape, seed=sum(shape), trailing=trailing))
    got = gain.gain_stream_batch(inc, bi, wi)
    assert torch.equal(got, ref.gain_stream_batch_ref(inc, bi, wi))
    assert torch.equal(got, gain.gain_stream_batch(inc, bi, wi))
    one = gain.gain_stream(inc, bi[-1].contiguous(), wi[-1].contiguous())
    assert torch.equal(one, ref.gain_stream_ref(inc, bi[-1], wi[-1]))
