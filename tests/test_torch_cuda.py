"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the CPU tier
holds the plain versions against the JAX package instead, in the other
``test_torch_*`` files).  The file imports no JAX, so it runs on a
machine without it; ``tests/conftest.py`` imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is integer and exact: the kernels must give the plain
versions' bits (tokenize: all four TokenStream fields; segreduce: the
reduced lanes at run-end rows and ``end_csum`` everywhere; the radix
kernels: every output, and the whole sort also ``torch.sort``'s stable
permutation of the packed key).
"""

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import radix_sort, segscan, tokenize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _text(n, seed):
    """n bytes of words, runs of whitespace, multi-byte UTF-8 and a few
    long words, so words straddle the kernel's 2048-byte tiles."""
    rng = np.random.default_rng(seed)
    words = [b"a", b"of", b"hello", b"\xc3\xa9t\xc3\xa9", b"x" * 300,
             b"word,", b"\xe2\x82\xac9", b"z" * 5000]
    seps = [b" ", b"\n", b"\t ", b"  \r\n", b"\x0b\x0c"]
    parts = []
    size = 0
    while size < n:
        w = words[int(rng.integers(0, len(words)))]
        s = seps[int(rng.integers(0, len(seps)))]
        parts += [w, s]
        size += len(w) + len(s)
    return np.frombuffer(b"".join(parts)[:n], dtype=np.uint8).copy()


@pytest.mark.parametrize("n,lanes", [
    (1, 2), (7, 2), (2048, 2), (2049, 3), (100_003, 2), (100_003, 3),
    (4_194_816, 2)])
def test_tokenize_kernel_matches_plain(dev, n, lanes):
    mults = (tokenize.HASH_A1, tokenize.HASH_A2, tokenize.HASH_A3)[:lanes]
    chunk = torch.from_numpy(_text(n, seed=n))
    want = tokenize._tokenize_plain(chunk, mults)
    got = tokenize._tokenize_cuda(chunk.to(dev), mults)
    torch.cuda.synchronize()
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_tokenize_kernel_edges(dev):
    """Whitespace only, a word at byte 0 and one running to the last byte,
    and a word across a tile edge."""
    mults = (tokenize.HASH_A1, tokenize.HASH_A2)
    cases = [b" \n\t" * 1000, b"w" + b" " * 4000 + b"end",
             b" " * 2040 + b"straddles-the-edge " + b"q" * 2100]
    for text in cases:
        chunk = torch.frombuffer(bytearray(text), dtype=torch.uint8)
        want = tokenize._tokenize_plain(chunk, mults)
        got = tokenize._tokenize_cuda(chunk.to(dev), mults)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _sorted_lanes(n, seed, key_range, n_lanes, invalid_frac=0.1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=(n, 2)).astype(np.uint32)
    keys[:, 0] ^= np.uint32(0x80000000) * (rng.random(n) < 0.5)
    valid = rng.random(n) >= invalid_frac
    k = torch.from_numpy(keys.view(np.int32).copy())
    k1 = torch.where(torch.from_numpy(valid), k[:, 0], -1)
    k2 = torch.where(torch.from_numpy(valid), k[:, 1], -1)
    perm = segscan._sort_perm(k1, k2, "variadic")
    vals = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, n_lanes))
    v = torch.from_numpy(vals.astype(np.int32))[perm]
    return k1[perm], k2[perm], [v[:, i] for i in range(n_lanes)]


def _pin_surface(k1, k2, got, want):
    """Equal on the equivalence surface: reduced lanes at run ends, the
    end count everywhere."""
    (g_red, g_csum), (w_red, w_csum) = got, want
    assert torch.equal(g_csum.cpu(), w_csum)
    _, _, is_end = segscan._run_flags(k1, k2)
    for g, w in zip(g_red, w_red):
        assert torch.equal(g.cpu()[is_end], w[is_end])


@pytest.mark.parametrize("n", [1, 2, 2047, 2048, 2049, 852_072, 1_572_864])
@pytest.mark.parametrize("op", ["unit", "sum", "min", "max",
                                ("sum", "min", "max")])
def test_segreduce_kernel_matches_plain(dev, n, op):
    lanes = 3 if isinstance(op, tuple) else 1
    k1, k2, vals = _sorted_lanes(n, seed=n, key_range=max(2, n // 8),
                                 n_lanes=lanes)
    unit = op == "unit"
    rop = "sum" if unit else op
    vals = [] if unit else vals
    want = segscan._segment_reduce_plain(k1, k2, vals, rop, unit)
    got = segscan._segment_reduce_cuda(
        k1.to(dev), k2.to(dev), [v.to(dev) for v in vals], rop, unit)
    torch.cuda.synchronize()
    _pin_surface(k1, k2, got, want)


def test_segreduce_kernel_all_invalid_and_one_run(dev):
    n = 5000
    sent = torch.full((n,), -1, dtype=torch.int32)
    got = segscan._segment_reduce_cuda(sent.to(dev), sent.to(dev), [],
                                       "sum", True)
    assert int(got[1][-1]) == 0
    one = torch.zeros(n, dtype=torch.int32)
    got = segscan._segment_reduce_cuda(one.to(dev), one.to(dev), [],
                                       "sum", True)
    assert int(got[1][-1]) == 1 and int(got[0][0][-1]) == n


def test_callable_op_on_cuda_raises(dev):
    k = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        segscan._segment_reduce_cuda(k, k, [k], lambda a, b: a + b, False)


def test_launch_counters_count_kernel_launches(dev):
    kc.reset_counts()
    chunk = torch.from_numpy(_text(5000, seed=1)).to(dev)
    tokenize.tokenize_hash(chunk)
    k = torch.zeros(10, dtype=torch.int32, device=dev)
    segscan.segment_reduce(k, k, [], "sum", True)
    assert kc.LAUNCHES == {"tokenize": 1, "segreduce": 1, "radix_hist": 0,
                           "radix_rank": 0, "radix_scatter": 0}
    assert all(v == 0 for v in kc.PLAIN_CALLS.values())


#: radix shapes: tiny, around the 4096-row tile, and the main path's
#: combiner (852,072) and fold (1,310,720) inputs
RADIX_NS = [1, 2, 4095, 4096, 4097, 100_003, 852_072, 1_310_720]
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 dtype=np.uint32)


def _radix_keys(case, n, seed):
    rng = np.random.default_rng(seed)
    if case == "dup":
        k1 = rng.integers(0, 7, n).astype(np.uint32)
        k2 = rng.integers(0, 3, n).astype(np.uint32)
    elif case == "all-equal":
        k1 = np.full(n, 0x80000000, np.uint32)
        k2 = np.full(n, 0xFFFFFFFF, np.uint32)
    else:  # full range, edges, sentinel rows
        k1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        k1[rng.random(n) < 0.3] = rng.choice(EDGES)
        k2[rng.random(n) < 0.3] = rng.choice(EDGES)
        dead = rng.random(n) < 0.2
        k1[dead] = k2[dead] = np.uint32(0xFFFFFFFF)
    return (torch.from_numpy(k1.view(np.int32).copy()),
            torch.from_numpy(k2.view(np.int32).copy()))


@pytest.mark.parametrize("n", RADIX_NS)
def test_radix_hist_and_scatter_kernels_match_plain(dev, n):
    k1, k2 = _radix_keys("edges", n, seed=n)
    perm = torch.from_numpy(
        np.random.default_rng(n).permutation(n).astype(np.int32))
    for lane, shift in ((1, 0), (0, 24), (1, 16)):
        src = (k2 if lane else k1)[None]
        want_h = radix_sort._radix_hist_plain(src, shift, 0xFF, 256)
        got_h = radix_sort._radix_hist_cuda(src.to(dev), shift, 0xFF, 256)
        assert torch.equal(got_h.cpu(), want_h), (lane, shift)
        for p in (None, perm):
            want = tuple(torch.empty(n, dtype=torch.int32) for _ in range(3))
            got = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(3))
            radix_sort._radix_scatter_plain(k1, k2, p, lane, shift, want_h,
                                            want)
            radix_sort._radix_scatter_cuda(
                k1.to(dev), k2.to(dev), None if p is None else p.to(dev),
                lane, shift, got_h, got)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (lane, shift, p is None)


@pytest.mark.parametrize("n", RADIX_NS)
@pytest.mark.parametrize("case", ["dup", "all-equal", "edges"])
def test_radix_sort_kernels_match_plain_and_torch_sort(dev, case, n):
    k1, k2 = _radix_keys(case, n, seed=n + 1)
    got = radix_sort.radix_sort_pairs(k1.to(dev), k2.to(dev))
    torch.cuda.synchronize()
    packed = (kc.u32(k1) - 2 ** 31) * 2 ** 32 + kc.u32(k2)
    order = torch.sort(packed, stable=True).indices
    assert torch.equal(got[2].cpu().to(torch.int64), order)
    assert torch.equal(got[0].cpu(), k1[order])
    assert torch.equal(got[1].cpu(), k2[order])
    if n <= 100_003:  # the plain passes, at the smaller shapes
        want = radix_sort.radix_sort_pairs(k1, k2)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("P,b,n", [(1, 1, 1), (8, 1, 4097), (8, 8, 262_144),
                                   (255, 2, 100_003), (255, 1, 9000)])
def test_radix_plan_kernels_match_plain(dev, P, b, n):
    rng = np.random.default_rng(P + n)
    dest = torch.from_numpy(rng.integers(0, P + 1, (b, n)).astype(np.int32))
    dest[:, ::97] = P  # dropped rows rank among themselves
    want_h = radix_sort._radix_hist_plain(dest, 0, kc.MASK32, P + 1)
    got_h = radix_sort._radix_hist_cuda(dest.to(dev), 0, kc.MASK32, P + 1)
    assert torch.equal(got_h.cpu(), want_h)
    want = radix_sort._radix_rank_plain(dest, want_h, P + 1)
    got = radix_sort._radix_rank_cuda(dest.to(dev), got_h, P + 1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    rank, counts = radix_sort.radix_partition_plan(dest.to(dev), P)
    assert torch.equal(counts.cpu(), want[1][:, :P])


def test_radix_launch_counters(dev):
    kc.reset_counts()
    k = torch.arange(10_000, dtype=torch.int32, device=dev)
    radix_sort.radix_sort_pairs(k, k)
    radix_sort.radix_partition_plan(k[None] % 9, 8)
    assert kc.LAUNCHES["radix_hist"] == radix_sort.RADIX_PASSES + 1
    assert kc.LAUNCHES["radix_scatter"] == radix_sort.RADIX_PASSES
    assert kc.LAUNCHES["radix_rank"] == 1
    assert all(v == 0 for v in kc.PLAIN_CALLS.values())
