"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the CPU tier
holds the plain versions against the JAX package instead, in the other
``test_torch_*`` files).  The file imports no JAX, so it runs on a
machine without it; ``tests/conftest.py`` imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The word-count kernels' comparisons are integer and exact: the kernels
must give the plain versions' bits (tokenize: all four TokenStream
fields; segreduce: the reduced lanes at run-end rows and ``end_csum``
everywhere; the radix kernels: every output, and the whole sort also
``torch.sort``'s stable permutation of the packed key and its own bits
on a repeat).  The flash kernels accumulate in another order than their
plain versions, so they are held to atol = rtol = 2e-2 on the bf16/fp16
outputs (out, dq, dk, dv: a few units in the last place of the 8-bit
mantissa) and atol 1e-3 on the f32 lse.  The word-count paths through
the feeder, the staged handle and the tier policy are held to
``Counter`` (and a forced-cold tiered run to the 'radix' run's bits).
The training plane's captured steps (one CUDA graph replay: the digits
MLP's epoch, the transformer's AdamW steps, the MoE trainer's SGD steps)
are held bit for bit against the same eager steps.  The ring's steps and
the MoE + ring trainer's step are held against the same on the plain
flash versions (the flash tolerance; the step's loss within 1e-2 and
updates within 5e-2 of their norms), the pipeline against its
sequential stages.
"""

import re
from collections import Counter

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch.models import TransformerConfig, TransformerTrainer
from mapreduce_tpu_torch.models import transformer as tmod
from mapreduce_tpu_torch.ops import flash_attention as fa
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import radix_sort, segscan, tokenize
from mapreduce_tpu_torch.testing import monoids
from mapreduce_tpu_torch.utils import compile_cache

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


#: the tile sizes the tokenize and segreduce kernels are built with in
#: chip_smoke.py's A/B (the default build is one of them)
SCAN_TILES = (1024, 2048, 4096)
M3 = (tokenize.HASH_A1, tokenize.HASH_A2, tokenize.HASH_A3)


def _pin_tokens(chunk, mults, dev):
    want = tokenize._tokenize_plain(chunk, mults)
    got = tokenize._tokenize_cuda(chunk.to(dev), mults)
    torch.cuda.synchronize()
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


#: inputs that walk the look-back chain: no tile but the first holds a
#: whitespace byte, or whole tiles of whitespace hold no word start
CHAIN_TEXTS = {
    "one-word-300k": b"w" * 300_000,
    "word-200k-spaces-word": b"first" + b" " * 200_000 + b"last",
    "whitespace-only-300k": b" \t\n\r\x0b\x0c" * 50_000,
    "mixed-runs": (b"ab" * 5000 + b" " * 9000) * 20,
}


@pytest.mark.parametrize("name", sorted(CHAIN_TEXTS))
@pytest.mark.parametrize("lanes", [2, 3])
def test_tokenize_kernel_look_back_chains(dev, name, lanes):
    chunk = torch.frombuffer(bytearray(CHAIN_TEXTS[name]), dtype=torch.uint8)
    _pin_tokens(chunk, M3[:lanes], dev)


@pytest.mark.parametrize("n", sorted(t + d for t in SCAN_TILES
                                     for d in (-1, 0, 1)))
@pytest.mark.parametrize("lanes", [1, 3])
def test_tokenize_kernel_around_tiles(dev, n, lanes):
    _pin_tokens(torch.from_numpy(_text(n, seed=n)), M3[:lanes], dev)


def test_tokenize_kernel_unaligned_chunk(dev):
    """A chunk that starts off a 16-byte boundary takes the byte loads."""
    chunk = torch.from_numpy(_text(100_003, seed=3))
    whole = chunk.to(dev)
    want = tokenize._tokenize_plain(chunk[3:], M3[:2])
    got = tokenize._tokenize_cuda(whole[3:], M3[:2])
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _repeats_and_replays(fn):
    """20 calls in a row, then 50 replays of one call captured in a CUDA
    graph: every output bit-equal to the first call's.  The look-back's
    counter and flags are zeroed inside each call, and a race in the
    walk shows as a run-to-run difference."""
    first = [t.clone() for t in _flat(fn())]
    for _ in range(20):
        assert all(torch.equal(a, b) for a, b in zip(_flat(fn()), first))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _flat(fn())
    for _ in range(50):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, first))


@pytest.mark.parametrize("name", ["text", "one-word-300k"])
def test_tokenize_kernel_repeats_and_replays_bit_for_bit(dev, name):
    text = (_text(4_194_816, seed=9).tobytes() if name == "text"
            else CHAIN_TEXTS[name])
    chunk = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(dev)
    _repeats_and_replays(lambda: tokenize._tokenize_cuda(chunk, M3[:2]))


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


def _one_run_lanes(n, seed):
    """n rows of one key, values across the int32 range (the sum wraps)."""
    rng = np.random.default_rng(seed)
    k = torch.full((n,), 0x1234, dtype=torch.int32)
    vals = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (n, 3))
                            .astype(np.int32))
    return k, k.clone(), [vals[:, i].contiguous() for i in range(3)]


def _sentinel_tail_lanes(n, valid, seed):
    """Sorted runs over the first *valid* rows, then the sentinel."""
    k1, k2, vals = _sorted_lanes(valid, seed, key_range=valid // 50,
                                 n_lanes=3, invalid_frac=0.0)
    tail = torch.full((n - valid,), -1, dtype=torch.int32)
    rng = np.random.default_rng(seed + 1)
    vtail = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n - valid)
                             .astype(np.int32))
    return (torch.cat([k1, tail]), torch.cat([k2, tail]),
            [torch.cat([v, vtail]) for v in vals])


def _single_row_runs(n, seed):
    k1 = torch.arange(n, dtype=torch.int32) * 7 - 2 ** 31 + 5
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (n, 3))
                            .astype(np.int32))
    return k1, k1 ^ 0x5A5A, [vals[:, i].contiguous() for i in range(3)]


#: inputs that walk the look-back chain (a run, or invalid rows, over
#: many tiles) or end a run on every row
CHAIN_LANES = {
    "one-run-500k": lambda: _one_run_lanes(500_000, 1),
    "sentinel-tail": lambda: _sentinel_tail_lanes(600_000, 20_000, 2),
    "single-row-runs": lambda: _single_row_runs(300_001, 3),
}


@pytest.mark.parametrize("name", sorted(CHAIN_LANES))
@pytest.mark.parametrize("op", ["unit", "sum", "min", "max",
                                ("sum", "min", "max")])
def test_segreduce_kernel_look_back_chains(dev, name, op):
    k1, k2, vals = CHAIN_LANES[name]()
    unit = op == "unit"
    rop = "sum" if unit else op
    vals = [] if unit else vals[:3 if isinstance(op, tuple) else 1]
    want = segscan._segment_reduce_plain(k1, k2, vals, rop, unit)
    got = segscan._segment_reduce_cuda(
        k1.to(dev), k2.to(dev), [v.to(dev) for v in vals], rop, unit)
    torch.cuda.synchronize()
    _pin_surface(k1, k2, got, want)


@pytest.mark.parametrize("n", sorted(t + d for t in SCAN_TILES
                                     for d in (-1, 0, 1)))
def test_segreduce_kernel_around_tiles(dev, n):
    k1, k2, vals = _sorted_lanes(n, seed=n, key_range=max(2, n // 8),
                                 n_lanes=3)
    for op, lanes in (("sum", vals[:1]), (("sum", "min", "max"), vals)):
        want = segscan._segment_reduce_plain(k1, k2, lanes, op, False)
        got = segscan._segment_reduce_cuda(
            k1.to(dev), k2.to(dev), [v.to(dev) for v in lanes], op, False)
        _pin_surface(k1, k2, got, want)


def test_segreduce_kernel_unaligned_lanes(dev):
    """Key lanes that start off a 16-byte boundary take the word loads."""
    k1, k2, vals = _sorted_lanes(100_003, seed=4, key_range=9000, n_lanes=1)
    k1d, k2d = k1.to(dev), k2.to(dev)
    want = segscan._segment_reduce_plain(k1[1:], k2[1:], [vals[0][1:]],
                                         "sum", False)
    got = segscan._segment_reduce_cuda(k1d[1:], k2d[1:],
                                       [vals[0][1:].to(dev)], "sum", False)
    _pin_surface(k1[1:], k2[1:], got, want)


@pytest.mark.parametrize("name", ["sorted-852k", "one-run-500k"])
@pytest.mark.parametrize("unit", [True, False])
def test_segreduce_kernel_repeats_and_replays_bit_for_bit(dev, name, unit):
    k1, k2, vals = (_sorted_lanes(852_072, seed=8, key_range=80_000,
                                  n_lanes=3)
                    if name == "sorted-852k" else CHAIN_LANES[name]())
    k1, k2 = k1.to(dev), k2.to(dev)
    vals = [] if unit else [v.to(dev) for v in vals]
    op = "sum" if unit else ("sum", "min", "max")
    _repeats_and_replays(
        lambda: segscan._segment_reduce_cuda(k1, k2, vals, op, unit))


def test_callable_op_on_cuda_raises(dev):
    """A callable outside the lowering's node set raises by name before
    any launch; so do more lanes than the monoid kernel takes."""
    k = torch.zeros(4, dtype=torch.int32, device=dev)
    kc.reset_counts()
    with pytest.raises(NotImplementedError, match="floordiv"):
        segscan._segment_reduce_cuda(k, k, [k], lambda a, b: a // b, False)
    with pytest.raises(NotImplementedError, match="1 to 8"):
        segscan._segment_reduce_cuda(k, k, [k] * 9, torch.add, False)
    assert kc.LAUNCHES["segreduce_monoid"] == 0


#: lane counts the lane-wise monoids run at on the card
LANE_WISE = {"xor": torch.bitwise_xor, "add": torch.add}


@pytest.mark.parametrize("n,key_range", [(1, 2), (2049, 256), (100_003, 3),
                                         (852_072, 80_000)])
@pytest.mark.parametrize("name", sorted(monoids.MONOIDS))
def test_monoid_kernel_matches_plain(dev, name, n, key_range):
    """Each callable monoid's kernel against the plain ladder: the
    reduced lanes at run ends and the end count, bit for bit (key range
    3: runs across many tiles, the look-back chain)."""
    op, lanes = monoids.MONOIDS[name]
    k1, k2, vals = _sorted_lanes(n, seed=n + lanes, key_range=key_range,
                                 n_lanes=lanes)
    want = segscan._segment_reduce_plain(k1, k2, vals, op, False)
    kc.reset_counts()
    got = segscan._segment_reduce_cuda(
        k1.to(dev), k2.to(dev), [v.to(dev) for v in vals], op, False)
    torch.cuda.synchronize()
    _pin_surface(k1, k2, got, want)
    assert kc.LAUNCHES["segreduce_monoid"] == 1
    assert kc.LAUNCHES["segreduce"] == 0


@pytest.mark.parametrize("lanes", range(1, 9))
@pytest.mark.parametrize("name", sorted(LANE_WISE))
def test_monoid_kernel_lane_wise_at_every_lane_count(dev, name, lanes):
    """A lane-wise monoid's library takes 1 to 8 lanes."""
    op = LANE_WISE[name]
    k1, k2, vals = _sorted_lanes(50_001, seed=lanes, key_range=400,
                                 n_lanes=lanes)
    want = segscan._segment_reduce_plain(k1, k2, vals, op, False)
    got = segscan._segment_reduce_cuda(
        k1.to(dev), k2.to(dev), [v.to(dev) for v in vals], op, False)
    torch.cuda.synchronize()
    _pin_surface(k1, k2, got, want)


def _runs_of_two(n, seed, n_lanes):
    """Sorted valid keys in runs of one or two rows, and random int32
    lanes with the extremes among them."""
    rng = np.random.default_rng(seed)
    head = rng.random(n) < 0.6
    head[0] = True
    head[1:] |= ~head[:-1]  # no two rows in a row continue a run
    k1 = torch.from_numpy((np.cumsum(head) - 1).astype(np.int32))
    k2 = torch.full((n,), 7, dtype=torch.int32)
    vals = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, n_lanes),
                        endpoint=True).astype(np.int32)
    vals[:4] = np.array([-2 ** 31, 2 ** 31 - 1, -1, 0],
                        dtype=np.int32)[:, None]
    v = torch.from_numpy(vals)
    return k1, k2, [v[:, i].contiguous() for i in range(n_lanes)]


@pytest.mark.parametrize("name", sorted(monoids.NODE_CASES)
                         + ["bits"])
def test_monoid_kernel_node_forms_on_runs_of_two(dev, name):
    """The generated C++ of every node form the lowering takes, held
    against the plain ladder where a run's result is one ``op(x, y)``,
    so that an op need not be associative: shifts, constants, unary
    ``-``, ``~`` and ``!``, ``-``, every comparison, bool ``& | ^``,
    ``where`` with a constant branch, methods, lane-wise ops."""
    op, lanes = (monoids.NODE_CASES.get(name) or monoids.MONOIDS[name])
    k1, k2, vals = _runs_of_two(300_007, seed=lanes, n_lanes=lanes)
    want = segscan._segment_reduce_plain(k1, k2, vals, op, False)
    kc.reset_counts()
    got = segscan._segment_reduce_cuda(
        k1.to(dev), k2.to(dev), [v.to(dev) for v in vals], op, False)
    torch.cuda.synchronize()
    _pin_surface(k1, k2, got, want)
    assert kc.LAUNCHES["segreduce_monoid"] == 1


@pytest.mark.parametrize("name", sorted(monoids.CODES))
def test_monoid_kernel_equals_the_codes_kernel(dev, name):
    """A callable and its per-lane codes: the two kernels give the same
    bits on the same rows."""
    op, lanes = monoids.MONOIDS[name]
    k1, k2, vals = _sorted_lanes(852_072, seed=7, key_range=80_000,
                                 n_lanes=lanes)
    k1, k2, vals = k1.to(dev), k2.to(dev), [v.to(dev) for v in vals]
    a = segscan._segment_reduce_cuda(k1, k2, vals, op, False)
    b = segscan._segment_reduce_cuda(k1, k2, vals, monoids.CODES[name],
                                     False)
    torch.cuda.synchronize()
    _, _, is_end = segscan._run_flags(k1, k2)
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x[is_end], y[is_end])


@pytest.mark.parametrize("name", ["span", "affine", "argmin_count"])
def test_monoid_kernel_repeats_and_replays_bit_for_bit(dev, name):
    """Eager calls and a CUDA-graph replay of one call give the first
    call's bits."""
    op, lanes = monoids.MONOIDS[name]
    k1, k2, vals = _sorted_lanes(852_072, seed=8, key_range=3,
                                 n_lanes=lanes)
    k1, k2, vals = k1.to(dev), k2.to(dev), [v.to(dev) for v in vals]
    _repeats_and_replays(
        lambda: segscan._segment_reduce_cuda(k1, k2, vals, op, False))


def test_launch_counters_count_kernel_launches(dev):
    kc.reset_counts()
    chunk = torch.from_numpy(_text(5000, seed=1)).to(dev)
    tokenize.tokenize_hash(chunk)
    k = torch.zeros(10, dtype=torch.int32, device=dev)
    segscan.segment_reduce(k, k, [], "sum", True)
    segscan.segment_reduce(k, k, [k, k], monoids.max_add, False)
    assert kc.LAUNCHES == {"tokenize": 1, "segreduce": 1, "radix_plan": 0,
                           "radix_upfront": 0, "radix_onesweep": 0,
                           "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                           "segreduce_monoid": 1}
    assert all(v == 0 for v in kc.PLAIN_CALLS.values())


#: radix shapes: tiny, around 4,096 rows, and the main path's combiner
#: (852,072) and fold (1,310,720) inputs
RADIX_NS = [1, 2, 4095, 4096, 4097, 100_003, 852_072, 1_310_720]
#: and around the sort's onesweep tile (one tile, and two and a row)
SORT_NS = sorted(set(RADIX_NS) | {radix_sort.RADIX_SORT_TILE + d
                                  for d in (-1, 0, 1)}
                 | {2 * radix_sort.RADIX_SORT_TILE + 1})
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


@pytest.mark.parametrize("n", SORT_NS)
def test_radix_upfront_and_onesweep_kernels_match_plain(dev, n):
    k1, k2 = _radix_keys("edges", n, seed=n)
    perm = torch.from_numpy(
        np.random.default_rng(n).permutation(n).astype(np.int32))
    want_t = radix_sort._radix_upfront_plain(k1, k2)
    got_t = radix_sort._radix_upfront_cuda(k1.to(dev), k2.to(dev))
    assert torch.equal(got_t.cpu(), want_t)
    for lane, shift in ((1, 0), (0, 24), (1, 16)):
        counts = want_t[radix_sort.PASSES.index((lane, shift))]
        for p in (None, perm):
            want = tuple(torch.empty(n, dtype=torch.int32) for _ in range(3))
            got = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(3))
            radix_sort._radix_onesweep_plain(k1, k2, p, lane, shift, counts,
                                             want)
            radix_sort._radix_onesweep_cuda(
                k1.to(dev), k2.to(dev), None if p is None else p.to(dev),
                lane, shift, counts.to(dev), got)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (lane, shift, p is None)


@pytest.mark.parametrize("n", SORT_NS)
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


def test_radix_sort_repeats_bit_for_bit(dev):
    """The look-back's flags start from zero on every call: 20 sorts of
    one input in a row give the first one's bits."""
    k1, k2 = (t.to(dev) for t in _radix_keys("edges", 1_310_720, seed=5))
    first = radix_sort.radix_sort_pairs(k1, k2)
    for _ in range(20):
        again = radix_sort.radix_sort_pairs(k1, k2)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_radix_sort_limits_raise(dev):
    k = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        radix_sort._radix_upfront_cuda(k, k.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        radix_sort._radix_onesweep_cuda(k, k, None, 1, 0, k, (k, k, k))


#: the plan's tile
PTILE = radix_sort.RADIX_TILE


def _plan_dest(case, P, b, n, seed):
    """``[b, n]`` int32 destinations in ``[0, P]``: uniform, with one batch
    row wholly dropped, with a one-bucket head (the early tiles), with one
    row all in one bucket, or skewed to one bucket and the dropped one."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, P + 1, (b, n)).astype(np.int32)
    if case == "row-dropped":
        dest[b // 2] = P
    elif case == "one-bucket-head":
        dest[:, : 2 * PTILE + 7] = P // 2
    elif case == "row-one-bucket":
        dest[0] = P // 2
    elif case == "skewed":
        dest[rng.random((b, n)) < 0.9] = 0
        dest[:, ::97] = P
    return torch.from_numpy(dest)


#: (case, P, batch, n): n around the tile, several tiles with a dropped
#: row or a one-bucket head, the partition limits, batch 1 and 8, the
#: slice's [8, 262,144], and look-back chains of 64+ tiles a row
PLAN_CASES = [("uniform", 3, 1, 1), ("uniform", 8, 1, PTILE - 1),
              ("uniform", 8, 1, PTILE), ("uniform", 8, 8, PTILE + 1),
              ("row-dropped", 8, 8, 3 * PTILE + 5),
              ("one-bucket-head", 8, 1, 4 * PTILE - 3),
              ("uniform", 1, 8, 2 * PTILE + 1),
              ("uniform", 255, 1, PTILE + 100),
              ("one-bucket-head", 255, 8, 3 * PTILE),
              ("skewed", 8, 8, 262_144), ("uniform", 8, 8, 262_144),
              ("row-one-bucket", 8, 2, 70 * PTILE + 3),
              ("row-dropped", 8, 3, 64 * PTILE),
              ("skewed", 255, 2, 1_310_720), ("uniform", 8, 1, 5_000_000)]


@pytest.mark.parametrize("case,P,b,n", PLAN_CASES)
def test_radix_plan_kernel_matches_plain(dev, case, P, b, n):
    dest = _plan_dest(case, P, b, n, seed=P + b + n)
    want_rank, want_totals = radix_sort._radix_plan_plain(dest, P + 1)
    got_rank, got_totals = radix_sort._radix_plan_cuda(dest.to(dev), P + 1)
    torch.cuda.synchronize()
    assert torch.equal(got_rank.cpu(), want_rank)
    assert torch.equal(got_totals.cpu(), want_totals)
    rank, counts = radix_sort.radix_partition_plan(dest.to(dev), P)
    assert torch.equal(rank.cpu(), want_rank)
    assert torch.equal(counts.cpu(), want_totals[:, :P])
    if b == 1:  # the unbatched form
        r1, c1 = radix_sort.radix_partition_plan(dest[0].to(dev), P)
        assert torch.equal(r1.cpu(), want_rank[0])
        assert torch.equal(c1.cpu(), want_totals[0, :P])


@pytest.mark.parametrize("case,P,b,n", [("uniform", 8, 8, 262_144),
                                        ("row-one-bucket", 8, 2,
                                         70 * PTILE + 3)])
def test_radix_plan_repeats_and_replays_bit_for_bit(dev, case, P, b, n):
    """The scratch (tile counter, look-back words) is zeroed by the memset
    inside the C call, so 20 calls and 50 graph replays give the first
    call's bits."""
    dest = _plan_dest(case, P, b, n, seed=1).to(dev)
    _repeats_and_replays(lambda: radix_sort.radix_partition_plan(dest, P))


def test_radix_plan_limits_raise(dev):
    d = torch.zeros((1, 10), dtype=torch.int32, device=dev)
    for P in (0, radix_sort.MAX_PARTITIONS + 1):
        with pytest.raises(ValueError, match="partitions"):
            radix_sort.radix_partition_plan(d, P)
    wide = torch.zeros((radix_sort.MAX_PLAN_BATCH + 1, 1),
                       dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="batch rows"):
        radix_sort.radix_partition_plan(wide, 8)
    long_row = torch.empty((1, radix_sort.MAX_PLAN_ROWS + 1),
                           dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="rows a batch row"):
        radix_sort.radix_partition_plan(long_row, 8)
    del long_row
    with pytest.raises(ValueError, match="contiguous"):
        radix_sort._radix_plan_cuda(d.to(torch.int64), 9)


def test_radix_launch_counters(dev):
    kc.reset_counts()
    k = torch.arange(10_000, dtype=torch.int32, device=dev)
    radix_sort.radix_sort_pairs(k, k)
    assert kc.LAUNCHES["radix_plan"] == 0
    for calls in (1, 2, 3):
        radix_sort.radix_partition_plan(k[None] % 9, 8)
        assert kc.LAUNCHES["radix_plan"] == calls
    assert kc.LAUNCHES["radix_upfront"] == 1
    assert kc.LAUNCHES["radix_onesweep"] == radix_sort.RADIX_PASSES
    assert all(v == 0 for v in kc.PLAIN_CALLS.values())


# -- flash attention -------------------------------------------------------------

#: (B, H, Tq, Tk, D, causal): D 64 and 128 causal and full, ragged T (not
#: a multiple of the 64-row tile), Tq != Tk both ways, T = 1, and head
#: dims that fill part of the 64- or 128-wide accumulators
FLASH_CASES = [
    (1, 2, 128, 128, 64, True), (1, 2, 128, 128, 64, False),
    (2, 2, 256, 256, 128, True), (2, 2, 256, 256, 128, False),
    (1, 3, 200, 200, 64, True), (1, 2, 2000, 2000, 64, True),
    (1, 2, 130, 70, 128, True), (1, 2, 70, 130, 64, True),
    (1, 2, 70, 130, 128, False), (1, 1, 1, 1, 16, True),
    (1, 2, 100, 100, 32, True), (1, 2, 64, 64, 48, False),
    (1, 2, 96, 96, 112, True),
    # one row either side of the 128-row tiles (TMA zero-fills the rest)
    (1, 2, 127, 127, 64, True), (1, 2, 129, 129, 128, True),
    (1, 2, 255, 255, 128, False), (1, 2, 257, 257, 64, True),
    (1, 1, 2049, 2049, 128, True),
    # Tq != Tk with one side below one tile
    (1, 2, 50, 300, 128, True), (1, 2, 300, 50, 64, True),
    (1, 2, 100, 257, 128, False),
    # head dims that fill part of the 64-wide (16, 48) and 128-wide (80,
    # 112) instantiations, where TMA zero-fills the columns past D
    (1, 2, 200, 200, 16, False), (1, 2, 200, 200, 48, True),
    (1, 2, 200, 200, 80, True), (1, 2, 200, 200, 112, False),
    # under 129 query rows (one past a 128-row tile), Tk one below, at
    # and one past 64 keys, and one below and at a 128-key tile
    (1, 2, 129, 63, 128, True), (1, 2, 129, 64, 64, False),
    (1, 2, 129, 65, 128, True), (1, 2, 129, 127, 128, True),
    (1, 2, 129, 128, 64, False),
    # one query row against many keys; a causal Tq > Tk whose last Q
    # tiles run past every key tile
    (1, 2, 1, 300, 128, True), (1, 2, 300, 129, 128, True),
    # 300 heads x 3 tiles: the heaviest-first tile order wraps over B*H
    (2, 150, 300, 300, 64, True),
    # 70 heads whose K/V (1100 x 128) fill L2 by 59: a group of 59 heads
    # and a last group of 11
    (7, 10, 1100, 1100, 128, True),
    # the transformer slice's shape
    (4, 8, 2048, 2048, 128, True)]
FLASH_TOL = dict(atol=2e-2, rtol=2e-2)


def _flash_inputs(B, H, Tq, Tk, D, dtype, seed):
    """(q^, k, v, do) in *dtype* on the CPU, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def mk(T):
        return torch.from_numpy(
            rng.standard_normal((B, H, T, D)).astype(np.float32)).to(dtype)

    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    return fa._prescale(q, D ** -0.5), k, v, do


def _close(got, want, name, **tol):
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               msg=lambda m: f"{name}: {m}",
                               **(tol or FLASH_TOL))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain(dev, case, dtype):
    B, H, Tq, Tk, D, causal = case
    qh, k, v, do = _flash_inputs(B, H, Tq, Tk, D, dtype, seed=Tq + D)
    out, lse = fa.flash_fwd_plain(qh, k, v, causal)
    g_out, g_lse = fa._flash_fwd_cuda(qh.to(dev), k.to(dev), v.to(dev),
                                      causal)
    torch.cuda.synchronize()
    _close(g_out, out, "out")
    _close(g_lse, lse, "lse", atol=1e-3, rtol=0)
    delta = (do.float() * out.float()).sum(-1, keepdim=True) - 0.1
    scale = D ** -0.5
    dq = fa.flash_dq_plain(qh, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_dkv_plain(qh, k, v, do, lse, delta, causal)
    args = [t.to(dev) for t in (qh, k, v, do, lse, delta)]
    g_dq = fa._flash_dq_cuda(*args, causal, scale)
    g_dk, g_dv = fa._flash_dkv_cuda(*args, causal)
    torch.cuda.synchronize()
    _close(g_dq, dq, "dq")
    _close(g_dk, dk, "dk")
    _close(g_dv, dv, "dv")


@pytest.mark.parametrize("dtype,D,msg", [
    (torch.float32, 64, "bfloat16 or float16"),
    (torch.bfloat16, 24, "multiple of 16"),
    (torch.bfloat16, 144, "multiple of 16")])
def test_flash_kernel_limits_raise(dev, dtype, D, msg):
    kc.reset_counts()
    q = torch.zeros((1, 1, 8, D), dtype=dtype, device=dev)
    with pytest.raises(ValueError, match=msg):
        fa.flash_attention(q, q, q)
    assert kc.PLAIN_CALLS["flash_fwd"] == 0  # never the plain version
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16,
                        device=dev).transpose(1, 2)
        fa._flash_fwd_cuda(t, t, t, True)


def test_flash_launch_counters(dev):
    kc.reset_counts()
    q, k, v, _ = (t.to(dev).requires_grad_()
                  for t in _flash_inputs(1, 2, 128, 128, 64, torch.bfloat16,
                                         seed=3))
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    (out.float().square().sum() + lse.sum()).backward()
    assert (kc.LAUNCHES["flash_fwd"], kc.LAUNCHES["flash_dq"],
            kc.LAUNCHES["flash_dkv"]) == (1, 1, 1)
    assert all(v == 0 for v in kc.PLAIN_CALLS.values())


def test_trainer_step_kernels_match_plain(dev, monkeypatch):
    """One small SGD step on the card through the kernels, and again with
    the flash wrappers swapped for their plain versions: the loss within
    1e-2, each parameter's update within 5e-2 of its norm."""
    cfg = TransformerConfig(vocab=256, embed=128, n_layers=2, n_heads=2,
                            head_dim=64, ffn=256)
    tr = TransformerTrainer(cfg, learning_rate=1e-2, device=dev)
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 129))
    p0 = {n: t.clone() for n, t in tr.init_params().state_dict().items()}

    def run():
        params = tmod.Transformer(cfg, device=dev)
        params.load_state_dict(p0)
        params, loss = tr.step(params, toks)
        return float(loss), params.state_dict()

    kc.reset_counts()
    loss_k, pk = run()
    assert kc.LAUNCHES["flash_fwd"] == 2 and kc.LAUNCHES["flash_dkv"] == 2
    monkeypatch.setattr(fa, "flash_fwd", fa.flash_fwd_plain)
    monkeypatch.setattr(fa, "flash_dq", fa.flash_dq_plain)
    monkeypatch.setattr(fa, "flash_dkv", fa.flash_dkv_plain)
    loss_p, pp = run()
    assert abs(loss_k - loss_p) < 1e-2, (loss_k, loss_p)
    for n in p0:
        dk, dp = pk[n] - p0[n], pp[n] - p0[n]
        err = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        assert err < 5e-2, (n, err)


# -- the feeder, the staged path and the tier policy on the card ----------------

_FEED_WORDS = 300_000
_FEED_CHUNK = 1 << 16


@pytest.fixture(scope="module")
def feed_corpus():
    from mapreduce_tpu_torch.corpus import make_corpus

    data = make_corpus(_FEED_WORDS, _FEED_WORDS // 27, seed=3)
    return data, Counter(data.split())


def _feed_wc(parts=1, **over):
    from dataclasses import replace

    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    cfg = replace(wcmod.bench_engine_config(), local_capacity=1 << 16,
                  exchange_capacity=1 << 15, out_capacity=1 << 16, **over)
    return wcmod.DeviceWordCount(Partitions(parts, "cuda"),
                                 chunk_len=_FEED_CHUNK, config=cfg)


@pytest.mark.parametrize("waves", [1, 3, 6])
def test_streaming_counts_repeat(dev, feed_corpus, waves):
    """20 streaming runs a wave count, each equal to Counter: a wave
    freed to the copy stream's pool without being recorded on the
    kernels' stream, or a pinned buffer refilled before its copy ended,
    shows as counts that go wrong only sometimes."""
    data, want = feed_corpus
    wc = _feed_wc()
    for _ in range(20):
        tm = {}
        assert wc.count_bytes(data, timings=tm, waves=waves) == want
        assert tm["waves"] == waves


def test_count_staged_frees_the_staged_bytes(dev, feed_corpus):
    data, want = feed_corpus
    wc = _feed_wc()
    wc.count_bytes(data, waves=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    handle = wc.stage(data, waves=3)
    staged = sum(t.numel() * t.element_size() for t in handle[2][0])
    assert torch.cuda.memory_allocated() - base >= staged
    tm = {}
    assert wc.count_staged(handle, timings=tm) == want
    assert "upload_s" not in tm and handle[2][0] == []
    del handle
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base


def test_forced_cold_tiered_radix_equals_radix(dev, feed_corpus):
    """A forced-cold 'tiered-radix' run (tier 0 on torch.sort, swapping
    to the radix kernels) gives the 'radix' run's bits."""
    from mapreduce_tpu_torch.engine import tiering

    data, want = feed_corpus
    ref_wc = _feed_wc(8, sort_impl="radix")
    chunks, L = ref_wc._to_chunks(data)
    ref = ref_wc._engine_for(L).run(chunks, waves=3)
    wc = _feed_wc(8, sort_impl="tiered-radix")
    tm = {}
    with tiering.force_cold():
        got = wc._engine_for(L).run(chunks, timings=tm, waves=3)
    assert tm["tier_cold_start"] and tm["tier_swaps"] <= 1
    assert tm["tier_specialize_failed"] is None
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_concurrent_library_calls_build_once(dev, tmp_path, monkeypatch):
    """Two threads asking for one unbuilt library: one nvcc, one load."""
    import threading

    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(kc, "_LIBS", {})
    started = []
    real_start = kc._start_build

    def counted(name, defines=()):
        proc = real_start(name, defines)
        if proc is not None:
            started.append(name)
        return proc

    monkeypatch.setattr(kc, "_start_build", counted)
    defines = (("MR_CONCURRENT_BUILD_TEST", 1),)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(kc.library(
        "segreduce", segscan._SIGNATURES, defines))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert started == ["segreduce"]
    assert len(libs) == 2 and libs[0] is libs[1]


# -- the resident session on the card ------------------------------------------

_SESSION_WORDS = 120_000


@pytest.fixture(scope="module")
def session_chunks():
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.ops.tokenize import shard_text

    data = make_corpus(_SESSION_WORDS, _SESSION_WORDS // 27, seed=4)
    n = -(-len(data) // _FEED_CHUNK)
    chunks, _ = shard_text(data, -(-n // 8) * 8, pad_multiple=512,
                           pad_to=_FEED_CHUNK + 512)
    return chunks


def _session(parts, device, store=None, **over):
    from dataclasses import replace

    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    cfg = replace(wcmod.bench_engine_config(), local_capacity=1 << 16,
                  exchange_capacity=1 << 15, out_capacity=1 << 16,
                  unit_values=True, reduce_op="sum", **over)
    return EngineSession(Partitions(parts, device), wcmod._wordcount_map_fn,
                         cfg, k=2, spill=store)


def _feeds(chunks):
    """Three tenants, two uneven feeds each, interleaved."""
    cut = chunks.shape[0] // 3 + 1
    for lo, hi in ((0, cut), (cut, chunks.shape[0])):
        for i, task in enumerate(("t0", "t1", "t2")):
            yield task, chunks[lo:hi] if i != 1 else chunks[lo:hi][::-1]


def _pin_snap(got, want):
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.overflow == want.overflow == 0


@pytest.mark.parametrize("parts,sort_impl", [(1, "variadic"), (8, "radix")])
def test_session_snapshots_match_the_plain_session(dev, session_chunks,
                                                   parts, sort_impl):
    """Every tenant's snapshot after every feed, on the card, is the CPU
    plain session's bits over the same feeds; no plain version runs on
    the card path and every kernel of the path launches."""
    cuda = _session(parts, "cuda", sort_impl=sort_impl)
    plain = _session(parts, "cpu", sort_impl=sort_impl)
    for task, block in _feeds(session_chunks):
        plain.feed(block, task=task)
        kc.reset_counts()
        cuda.feed(block, task=task)
        snap = cuda.snapshot(task)
        assert not any(kc.PLAIN_CALLS.values()), kc.PLAIN_CALLS
        assert kc.LAUNCHES["tokenize"] > 0 and kc.LAUNCHES["segreduce"] > 0
        if sort_impl == "radix":
            assert kc.LAUNCHES["radix_plan"] > 0
            assert kc.LAUNCHES["radix_onesweep"] > 0
        _pin_snap(snap, plain.snapshot(task))
    assert np.array_equal(cuda.traffic_matrix("t1"),
                          plain.traffic_matrix("t1"))


def test_session_evict_restore_on_the_card(dev, session_chunks):
    """Evict to ``mem:`` storage, then the next snapshot restores lazily,
    bit-equal to the snapshot before; the stream feeds on equal to one
    that never left, and the eviction freed device memory."""
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.storage import MemoryStorage

    half = session_chunks.shape[0] // 2
    s = _session(8, "cuda", SessionSpillStore(MemoryStorage()),
                 sort_impl="radix")
    ref = _session(8, "cuda", sort_impl="radix")
    s.feed(session_chunks[:half], task="a")
    ref.feed(session_chunks[:half], task="a")
    before = s.snapshot("a")
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    s.evict("a")
    assert torch.cuda.memory_allocated() < mem and s.tasks() == []
    _pin_snap(s.snapshot("a"), before)
    s.feed(session_chunks[half:], task="a")
    ref.feed(session_chunks[half:], task="a")
    _pin_snap(s.snapshot("a"), ref.snapshot("a"))


def test_session_memory_policy_fires_on_the_card(dev, session_chunks):
    """``SpillPolicy(hbm_frac=...)`` below the allocated share evicts the
    coldest stream at the next feed's end (it never fires on the CPU)."""
    from mapreduce_tpu_torch.engine.spill import (
        SessionSpillStore, SpillPolicy)
    from mapreduce_tpu_torch.storage import MemoryStorage

    store = SessionSpillStore(MemoryStorage())
    s = _session(1, "cuda", store)
    s.feed(session_chunks[:8], task="cold")
    s.feed(session_chunks[8:16], task="hot")
    assert not SpillPolicy(hbm_frac=0.999).hbm_pressed(s.device)
    assert SpillPolicy(hbm_frac=1e-9).hbm_pressed(s.device)
    s.spill_policy = SpillPolicy(hbm_frac=1e-9)
    s.feed(session_chunks[16:24], task="hot")
    assert s.tasks() == ["hot"] and store.has("cold")


def test_session_without_its_library_raises(dev, session_chunks, tmp_path,
                                            monkeypatch):
    """A kernel library that cannot be built makes the feed raise (and
    poisons the stream); no plain version runs in its place."""
    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(kc, "_LIBS", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kc, "_nvcc", no_nvcc)
    s = _session(1, "cuda")
    kc.reset_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        s.feed(session_chunks[:8], task="t")
    assert not any(kc.PLAIN_CALLS.values())
    assert not any(kc.LAUNCHES.values())


def test_session_orders_reads_after_a_feed_on_another_stream(
        dev, session_chunks):
    """Feeds queued on a side stream, a snapshot and a spill read on the
    default one: the session's write events order them, with no
    device-wide synchronize, and the reads equal the plain session's."""
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.storage import MemoryStorage

    s = _session(1, "cuda", SessionSpillStore(MemoryStorage()))
    plain = _session(1, "cpu")
    side = torch.cuda.Stream()
    for lo in range(0, session_chunks.shape[0], 4):
        block = session_chunks[lo:lo + 4]
        plain.feed(block, task="t")
        with torch.cuda.stream(side):
            s.feed(block, task="t")
        _pin_snap(s.snapshot("t"), plain.snapshot("t"))
    s.evict("t")
    with torch.cuda.stream(side):
        _pin_snap(s.snapshot("t"), plain.snapshot("t"))


@pytest.mark.parametrize("parts,sort_impl", [(1, "variadic"),
                                             (8, "radix")])
def test_server_device_plane_on_the_card(dev, tmp_path, parts, sort_impl):
    """The job plane's device phase on the card: ``Server`` with
    ``device=True`` over three files equals ``Counter`` of their words,
    launches the path's kernels and calls no plain version."""
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.examples import wordcount as wcmod
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.server import Server

    lines = make_corpus(200_000, 8_000, seed=3).split(b"\n")
    files = []
    for i in range(3):
        path = tmp_path / f"f{i}.txt"
        path.write_bytes(b"\n".join(lines[i::3]))
        files.append(str(path))
    want = Counter()
    for f in files:
        want.update(w.decode() for w in open(f, "rb").read().split())
    mod = "mapreduce_tpu_torch.examples.wordcount"
    params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params.update(storage=f"mem:{uuid.uuid4().hex}", device=True,
                  partitions=Partitions(parts),
                  init_args={"files": files, "device_chunk_len": 1 << 18,
                             "device_sort_impl": sort_impl})
    spec.clear_caches()
    kc.reset_counts()
    server = Server(f"mem://{uuid.uuid4().hex}", "wc")
    server.configure(params)
    stats = server.loop()
    spec.clear_caches()
    assert dict(wcmod.RESULT) == dict(want)
    assert stats["device"]["waves"] >= 1
    assert not any(kc.PLAIN_CALLS.values()), kc.PLAIN_CALLS
    need = ["tokenize", "segreduce"]
    if sort_impl == "radix":
        need += ["radix_upfront", "radix_onesweep", "radix_plan"]
    for name in need:
        assert kc.LAUNCHES[name] > 0, (name, kc.LAUNCHES)


# -- the device telemetry on the card --------------------------------------------

#: identifiers of the engine's and the session's telemetry lines
_TELEMETRY_LINE = re.compile(
    r"\b(line\.|_memory_obs|_profile|_comms|_slo|TRACER|_WAVES|"
    r"_DISPATCHES|_RETRIES|_STAGE_SECONDS|_WAVE_SECONDS|_PARTITION_|"
    r"_SESSION|_FEEDS|_CHUNKS|_SNAPSHOTS|_LIVE_RECORDS|_OVERFLOWS|"
    r"_BACKPRESSURE|refresh_stream_age_gauges)")


def _sync_stacks(run):
    """Run *run* under ``set_sync_debug_mode("warn")``; returns the
    Python stack of every synchronising CUDA call it made."""
    import traceback
    import warnings

    stacks = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stacks.append(traceback.extract_stack()[:-1])

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return stacks


def _telemetry_frames(stacks):
    """The frames of *stacks* in the port's obs/ or on a telemetry line
    of its engine."""
    bad = []
    for st in stacks:
        for fr in st:
            path = fr.filename.replace("\\", "/")
            if "mapreduce_tpu_torch/obs/" in path or (
                    "mapreduce_tpu_torch/engine/" in path
                    and _TELEMETRY_LINE.search(fr.line or "")):
                bad.append(f"{path}:{fr.lineno} {fr.line}")
    return bad


@pytest.mark.parametrize("parts,sort_impl", [(1, "variadic"),
                                             (8, "radix")])
def test_engine_timeline_on_the_card(dev, feed_corpus, parts, sort_impl):
    """A streaming run's spans on the card: device_run ⊃ wave ⊃ {upload,
    compute, readback}, each child inside its wave, compute and upload
    device intervals with device_ms > 0, and a roofline share in
    (0, 1]."""
    from mapreduce_tpu_torch.obs.trace import TRACER

    data, want = feed_corpus
    wc = _feed_wc(parts, sort_impl=sort_impl)
    wc.count_bytes(data, waves=3)  # warm
    tm = {}
    with TRACER.span("root") as root:
        assert wc.count_bytes(data, timings=tm, waves=3) == want
    ev = [e for e in TRACER.events()
          if e["args"].get("trace_id") == root.trace_id]
    by_id = {e["args"]["span_id"]: e for e in ev}
    names = Counter(e["name"] for e in ev)
    assert names["device_run"] == 1
    assert names["wave"] == names["upload"] == names["compute"] \
        == tm["waves"] >= 2
    for e in ev:
        parent = by_id.get(e["args"]["parent_id"])
        if e["name"] in ("upload", "compute"):
            assert parent["name"] == "wave"
            assert e["args"]["clock"] == "device"
            assert e["args"]["device_ms"] > 0
        if parent is not None and parent["name"] in ("wave", "device_run"):
            assert parent["ts"] <= e["ts"] + 0.5
            assert (e["ts"] + e["dur"]
                    <= parent["ts"] + parent["dur"] + 0.5), e["name"]
    assert 0.0 < tm["roofline_frac"] <= 1.0
    assert tm["cost_source"] == "analytic"
    assert tm["peak_source"].startswith("kind:h100") \
        or tm["peak_source"].startswith("platform:gpu")


def test_telemetry_makes_no_synchronising_call(dev, feed_corpus):
    """Under sync-debug mode no synchronising call's stack passes
    through the port's obs/ or a telemetry line of the engine or the
    session (the engine's own overflow read and result copy do sync)."""
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    data, want = feed_corpus
    wc = _feed_wc(8, sort_impl="radix")
    wc.count_bytes(data, waves=3)  # warm: builds, the memory limit read
    chunks, _ = wc._to_chunks(data)
    sess = smod.EngineSession(Partitions(8, "cuda"),
                              wcmod._wordcount_map_fn, wc.config, k=2)
    sess.feed(chunks[:16], task="t")
    out = {}

    def run():
        out["counts"] = wc.count_bytes(data, waves=3)
        sess.feed(chunks[16:32], task="t")
        sess.snapshot("t")

    stacks = _sync_stacks(run)
    assert out["counts"] == want
    assert stacks, "sync-debug mode reported no sync at all"
    assert _telemetry_frames(stacks) == []


# -- the training plane: captured steps against eager ones ---------------------


def test_captured_mlp_epoch_equals_eager_steps(dev):
    """The digits trainer's epoch as one CUDA graph replay against the same
    S eager steps: bit for bit (no kernel of the step accumulates with
    atomics in a varying order), epoch after epoch."""
    from mapreduce_tpu_torch.models import (DistributedTrainer, MLPConfig,
                                            TrainConfig)

    tr = DistributedTrainer(MLPConfig(), TrainConfig(learning_rate=0.1,
                                                     momentum=0.9),
                            device=dev)
    rng = np.random.default_rng(0)
    S = 6
    xs = rng.normal(size=(2, S, 128, 256)).astype(np.float32)
    ys = rng.integers(0, 10, size=(2, S, 128)).astype(np.int32)
    a, b = tr.init_state(), tr.init_state()
    for e in range(2):
        a = tr._train_epoch(*a[:2], xs[e], ys[e])
        losses = []
        for i in range(S):
            b = tr.step(*b[:2], *tr.place_batch(xs[e, i], ys[e, i]))
            losses.append(b[2])
        assert torch.equal(a[2], torch.stack(losses)), e
        for n in a[0]:
            assert torch.equal(a[0][n], b[0][n]), (e, n)
            assert torch.equal(a[1][n], b[1][n]), (e, n)
    assert tr._graph.owners[0] is a[0]


def test_captured_transformer_steps_equal_eager_step_opt(dev):
    """``_train_steps`` (S AdamW steps in one graph replay) against S eager
    ``step_opt`` calls, bit for bit; the replay counts S launches of each
    flash kernel a layer."""
    cfg = TransformerConfig(vocab=256, embed=128, n_layers=2, n_heads=2,
                            head_dim=64, ffn=256)
    tr = TransformerTrainer(cfg, learning_rate=1e-3, optimizer="adamw",
                            device=dev)
    S = 3
    toks = np.random.default_rng(0).integers(0, 256, size=(S, 2, 129))
    (a, oa), (b, ob) = tr.init_state(), tr.init_state()
    tr._train_steps(a, oa, *tr.place_batch(toks))  # capture and a replay
    kc.reset_counts()
    a, oa, losses = tr._train_steps(a, oa, *tr.place_batch(toks))
    assert kc.LAUNCHES["flash_fwd"] == kc.LAUNCHES["flash_dkv"] == S * 2
    assert not any(kc.PLAIN_CALLS.values())
    want = []
    for _ in range(2):
        for i in range(S):
            b, ob, loss = tr.step_opt(b, ob, toks[i])
            want.append(float(loss))
    assert losses.tolist() == want[S:]
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n


# -- the expert, ring and pipeline paths on the card ---------------------------

#: a small MoE + ring config: two experts (n_model 2) and 4 sequence
#: partitions of 128 tokens, head_dim 64
_AXES_CFG = dict(vocab=256, embed=128, n_layers=2, n_heads=2, head_dim=64,
                 ffn=256, moe_experts=2)


def _swap_plain(monkeypatch):
    monkeypatch.setattr(fa, "flash_fwd", fa.flash_fwd_plain)
    monkeypatch.setattr(fa, "flash_dq", fa.flash_dq_plain)
    monkeypatch.setattr(fa, "flash_dkv", fa.flash_dkv_plain)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_kernels_match_plain(dev, monkeypatch, causal):
    """The ring's flash steps (non-causal blocks, a non-zero lse
    cotangent through dq and dkv) against the same ring on the plain
    versions: out and the q, k, v gradients at the flash tolerance; P
    launches of each kernel."""
    from mapreduce_tpu_torch.parallel.ring import ring_attention

    P = 4
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 1024, 4, 64)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))

    def run():
        qs, ks, vs = (t.to(dev).requires_grad_() for t in (q, k, v))
        out = ring_attention(qs, ks, vs, P, causal=causal)
        out.backward(do.to(dev))
        return out.detach(), qs.grad, ks.grad, vs.grad

    kc.reset_counts()
    got = run()
    assert (kc.LAUNCHES["flash_fwd"], kc.LAUNCHES["flash_dq"],
            kc.LAUNCHES["flash_dkv"]) == (P, P, P)
    assert not any(kc.PLAIN_CALLS.values())
    _swap_plain(monkeypatch)
    want = run()
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b.cpu(), name)


def test_moe_ring_step_kernels_match_plain(dev, monkeypatch):
    """One SGD step of the MoE + ring trainer through the kernels, and
    again on the plain flash versions: the loss within 1e-2, each update
    within 5e-2 of its norm; P launches of each kernel a layer."""
    cfg = TransformerConfig(**_AXES_CFG)
    tr = TransformerTrainer(cfg, learning_rate=1e-2, device=dev,
                            n_model=2, n_data=4)
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 513))
    p0 = {n: t.clone() for n, t in tr.init_params().state_dict().items()}

    def run():
        params = tmod.Transformer(tr.cfg, device=dev)
        params.load_state_dict(p0)
        params, loss = tr.step(params, toks)
        return float(loss), params.state_dict()

    kc.reset_counts()
    loss_k, pk = run()
    assert kc.LAUNCHES["flash_fwd"] == kc.LAUNCHES["flash_dkv"] == 4 * 2
    _swap_plain(monkeypatch)
    loss_p, pp = run()
    assert abs(loss_k - loss_p) < 1e-2, (loss_k, loss_p)
    for n in p0:
        dk, dp = pk[n] - p0[n], pp[n] - p0[n]
        err = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        assert err < 5e-2, (n, err)


@pytest.mark.parametrize("n_data", [1, 4])
def test_captured_moe_steps_equal_eager_steps(dev, n_data):
    """``_train_steps`` of the MoE trainer (routing, stable argsort,
    gathers and scatter-adds inside the graph: a host sync would fail the
    capture) against S eager SGD steps, bit for bit."""
    cfg = TransformerConfig(**_AXES_CFG)
    tr = TransformerTrainer(cfg, learning_rate=1e-2, device=dev, n_model=2,
                            n_data=n_data)
    S = 3
    toks = np.random.default_rng(1).integers(0, 256, size=(S, 2, 513))
    a, b = tr.init_params(), tr.init_params()
    a, _ = tr._train_steps(a, None, *tr.place_batch(toks))  # capture
    a, losses = tr._train_steps(a, None, *tr.place_batch(toks))
    want = []
    for _ in range(2):
        for i in range(S):
            b, loss = tr.step(b, toks[i])
            want.append(float(loss))
    assert losses.tolist() == want[S:]
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n


def test_pipeline_on_the_card_matches_its_reference(dev):
    """The pipelined forward (S = 8 stages, M = 16 microbatches, bf16)
    against the sequential stages at the flash tolerance, and a few SGD
    steps that lower the loss."""
    from mapreduce_tpu_torch.models import pipeline as pmod

    cfg = pmod.PipelineConfig()
    tr = pmod.PipelinedTrainer(cfg, learning_rate=0.1, n_stages=8,
                               device=dev)
    params = tr.init_params()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16 * cfg.microbatch, cfg.n_in)).astype(
        np.float32)
    got = pmod.pipeline_forward_local(params, torch.from_numpy(x).to(dev),
                                      cfg)
    want = pmod.pipeline_reference(params, x, cfg)
    _close(got, torch.from_numpy(want), "pipeline")
    y = x[:, :cfg.n_classes].argmax(-1)
    losses = [float(tr.step(params, x, y)[1]) for _ in range(20)]
    assert losses[-1] < losses[0], losses


# -- the always-on service: two device tasks at once ---------------------------


def _runner_files(tmp_path):
    from mapreduce_tpu_torch.corpus import make_corpus

    lines = make_corpus(300_000, 12_000, seed=5).split(b"\n")
    files = []
    for i in range(3):
        path = tmp_path / f"f{i}.txt"
        path.write_bytes(b"\n".join(lines[i::3]))
        files.append(str(path))
    return files


def _runner_tasks(sch, files, tmp_path, impls, tag):
    mod = "mapreduce_tpu_torch.examples.wordcount"
    ids = {}
    for impl in impls:
        params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                                   "reducefn", "finalfn")}
        params.update(storage=f"shared:{tmp_path / tag / impl}",
                      device=True, combinerfn=mod,
                      init_args={"files": files, "keep_results": True,
                                 "device_chunk_len": 1 << 18,
                                 "device_sort_impl": impl})
        ids[impl] = sch.submit(impl, db=f"{tag}_{impl}", params=params,
                               est_jobs=1)["_id"]
    return ids


def test_two_device_tasks_in_one_runner_count_exactly(dev, tmp_path):
    """Two device tasks (radix at P = 8, variadic) in flight at once in
    one TaskRunner: the launch counters read after both equal the sum of
    the two tasks run one at a time (no count lost between threads), no
    plain version runs, and each result equals its solo run's bytes."""
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.sched.scheduler import (
        DONE, Scheduler, SchedulerConfig)
    from mapreduce_tpu_torch.sched.service import TaskRunner, wait_for_state

    files = _runner_files(tmp_path)

    def serve(tag, impls):
        name = uuid.uuid4().hex
        sch = Scheduler(MemoryDocStore.named(name),
                        config=SchedulerConfig(max_inflight=2))
        ids = _runner_tasks(sch, files, tmp_path, impls, tag)
        spec.clear_caches()
        kc.reset_counts()
        runner = TaskRunner(f"mem://{name}", sch, poll=0.02,
                            partitions=Partitions(8)).start()
        try:
            for tid in ids.values():
                wait_for_state(sch, tid, DONE, timeout=120)
        finally:
            runner.stop(timeout=120)
            spec.clear_caches()
        torch.cuda.synchronize()
        out = {impl: (tmp_path / tag / impl / f"{tag}_{impl}.result.P00000"
                      ).read_bytes() for impl in impls}
        return dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS), out

    solo = [serve(f"solo{i}", [impl])
            for i, impl in enumerate(("radix", "variadic"))]
    both, plain, out = serve("both", ["radix", "variadic"])
    want = {k: solo[0][0][k] + solo[1][0][k] for k in kc.KERNELS}
    assert both == want
    assert want["radix_onesweep"] > 0 and want["tokenize"] > 0
    assert not any(plain.values())
    assert out["radix"] == solo[0][2]["radix"]
    assert out["variadic"] == solo[1][2]["variadic"]
    assert out["radix"] == out["variadic"]


def test_capture_keeps_another_threads_launches(dev):
    """A CUDA-graph capture tallies only what enqueues on its capture
    stream: a launch counted from another thread on another stream
    during the capture stays counted, and the replay adds the capture's
    launches once."""
    import threading

    chunk = torch.from_numpy(np.frombuffer(_text(1 << 16, 0),
                                           dtype=np.uint8).copy()).to(dev)
    tokenize.tokenize_hash(chunk)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    kc.reset_counts()

    def other():
        with torch.cuda.stream(side):
            kc.count_launch("segreduce", 3)

    def body():
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        return tokenize.tokenize_hash(chunk)

    g = kc.CapturedGraph(body)
    assert g.launches == {k: int(k == "tokenize") for k in kc.KERNELS}
    assert kc.LAUNCHES["segreduce"] == 3 and kc.LAUNCHES["tokenize"] == 0
    g.replay()
    torch.cuda.synchronize()
    assert kc.LAUNCHES["tokenize"] == 1


# -- the remaining examples and the compile plane on the card ---------------------


def _span_files(tmp_path):
    from mapreduce_tpu_torch.corpus import make_corpus

    lines = make_corpus(300_000, 12_000, seed=5).split(b"\n")
    files = []
    for i in range(3):
        path = tmp_path / f"s{i}.txt"
        path.write_bytes(b"\n".join(lines[i::3]))
        files.append(str(path))
    return files


def _wordspan(files, parts, sort_impl, autotune=None):
    """``examples/wordspan`` through ``Server(device=True)`` at capacities
    the files' ~40K uniques overflow; its RESULT and device timings.
    The monoid is the module's ``SPAN_REDUCE_OP`` (a test may patch in
    the per-lane codes)."""
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.examples import wordspan as tws
    from mapreduce_tpu_torch.server import Server

    mod = "mapreduce_tpu_torch.examples.wordspan"
    params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params.update(combinerfn=mod, storage=f"mem:{uuid.uuid4().hex}",
                  device=True, partitions=parts,
                  init_args={"files": files, "device_chunk_len": 1 << 18,
                             "device_local_capacity": 1 << 12,
                             "device_exchange_capacity": 1 << 10,
                             "device_out_capacity": 1 << 12,
                             "device_sort_impl": sort_impl})
    spec.clear_caches()
    tws._conf.clear()
    tws._conf.update({"files": [], "num_reducers": 8})
    server = Server(f"mem://{uuid.uuid4().hex}", "ws")
    server.autotune = autotune
    server.configure(params)
    server.loop()
    spec.clear_caches()
    return dict(tws.RESULT), server._last_device_timings


@pytest.mark.parametrize("parts,sort_impl", [(1, "variadic"), (8, "radix")])
def test_wordspan_on_the_card_equals_the_cpu_run(dev, tmp_path, parts,
                                                 sort_impl):
    """Spans on the card (the callable 3-lane monoid's segreduce kernel;
    at P = 8 the radix kernels) equal the same run's plain versions on
    the CPU, through the capacity retries."""
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    files = _span_files(tmp_path)
    want, cpu_tm = _wordspan(files, Partitions(parts, "cpu"), sort_impl)
    kc.reset_counts()
    got, tm = _wordspan(files, Partitions(parts), sort_impl)
    assert got == want
    assert tm["retries"] >= 1 and tm["retries"] == cpu_tm["retries"]
    assert not any(kc.PLAIN_CALLS.values()), kc.PLAIN_CALLS
    # the callable span monoid runs on its monoid kernel
    need = ["tokenize", "segreduce_monoid"]
    if sort_impl == "radix":
        need += ["radix_upfront", "radix_onesweep", "radix_plan"]
    for name in need:
        assert kc.LAUNCHES[name] > 0, (name, kc.LAUNCHES)


def test_registry_round_trip_through_warmup_replay(dev, tmp_path,
                                                   monkeypatch):
    """Runs on the card record their buckets in the enabled cache's
    registry, and a fresh controller pre-sizes the next run from it: no
    retry.  The callable span monoid's buckets keep their capacities
    alone (no replay spec, as the JAX engine's); a run with the per-lane
    codes records replay specs; ``warmup --replay`` replays every
    replayable bucket and reports the callable's skipped."""
    from mapreduce_tpu_torch.examples import wordspan as tws
    import contextlib
    import io
    import json

    from mapreduce_tpu_torch import cli
    from mapreduce_tpu_torch.engine.autotune import AutoTuner
    from mapreduce_tpu_torch.obs.control import ControlLedger
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    files = _span_files(tmp_path)
    saved = compile_cache.save_state()
    cache = str(tmp_path / "cache")
    try:
        compile_cache.enable_compile_cache(cache)
        want, tm = _wordspan(files, Partitions(1), "variadic")
        assert tm["retries"] >= 1
        ledger = ControlLedger()
        got, tm2 = _wordspan(files, Partitions(1), "variadic",
                             autotune=AutoTuner(ledger=ledger,
                                                repartition=False))
        with monkeypatch.context() as mp:
            mp.setattr(tws, "SPAN_REDUCE_OP", ("sum", "min", "max"))
            codes, _ = _wordspan(files, Partitions(1), "variadic")
    finally:
        compile_cache.restore_state(saved)
    assert got == want == codes and tm2["retries"] == 0
    (dec,) = ledger.decisions("capacity")
    assert "shape_registry" in dec["evidence"]["source"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["warmup", "--compile-cache", cache, "--replay",
                       "--json"])
    assert rc == 0
    doc = json.loads(out.getvalue().strip().splitlines()[-1])["warmup"]
    rows = doc["replay"]
    with open(f"{cache}/mrtpu_shape_registry.json") as f:
        recorded = json.load(f)["buckets"]
    assert len(rows) == len(recorded) >= 4
    replayed = [r for r in rows if "seconds" in r]
    skipped = [r for r in rows if "seconds" not in r]
    assert len(replayed) >= 2 and skipped, rows
    assert all(r["skipped"] == "no replay spec recorded" for r in skipped)
    assert len(replayed) == sum(
        1 for b in recorded.values() if (b.get("replay") or {}).get(
            "kind") == "device_engine")
    assert len(skipped) == sum(1 for b in recorded.values()
                               if "sizing" in b)


# -- the engine-host fleet and the multi-process mesh on the card -------------


def test_migration_on_the_card_is_bit_equal(dev, session_chunks):
    """``engine/migrate.migrate``: spill on the source session, the
    guarded route flip, a lazy restore on the destination; the
    destination's stream, fed on, is bit-equal to one that never moved,
    the route points at the destination, the move is one ``fleet``
    decision, and every kernel of the radix path ran on the card."""
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine.migrate import migrate
    from mapreduce_tpu_torch.engine.session import SessionBusyError
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.obs.control import ControlLedger
    from mapreduce_tpu_torch.storage import MemoryStorage

    board = docstore.connect("mem://cuda-fleet-migrate")
    for host in ("hostA", "hostB"):
        FleetMember(board, host_id=host).join(timeout=2.0)
    reg = FleetRegistry(board)
    reg.assign("t", "hostA", program="wave")
    store = SessionSpillStore(MemoryStorage())
    half = session_chunks.shape[0] // 2
    src = _session(8, "cuda", store, sort_impl="radix")
    dst = _session(8, "cuda", store, sort_impl="radix")
    ref = _session(8, "cuda", sort_impl="radix")
    kc.reset_counts()
    src.feed(session_chunks[:half], task="t")
    ref.feed(session_chunks[:half], task="t")
    before = src.snapshot("t")
    ledger = ControlLedger()
    res = migrate("t", src, dst, registry=reg, src_host="hostA",
                  dst_host="hostB", reason="explicit", ledger=ledger)
    assert res["routed"] and reg.route("t")["host"] == "hostB"
    with pytest.raises(SessionBusyError):
        src.feed(session_chunks[half:], task="t")
    _pin_snap(dst.snapshot("t"), before)        # the lazy restore
    dst.feed(session_chunks[half:], task="t")
    ref.feed(session_chunks[half:], task="t")
    _pin_snap(dst.snapshot("t"), ref.snapshot("t"))
    assert [d["outcome"] for d in ledger.decisions()] == ["applied"]
    assert not any(kc.PLAIN_CALLS.values()), kc.PLAIN_CALLS
    for name in ("tokenize", "segreduce", "radix_plan", "radix_upfront",
                 "radix_onesweep"):
        assert kc.LAUNCHES[name] > 0, name


def test_two_rank_gloo_count_on_the_card(dev, tmp_path):
    """Two processes, each ``Partitions(8, "cuda", group=WORLD)`` over a
    gloo group (4 partitions each, both on this card), radix: each
    rank's count equals ``Counter`` and the other rank's result bit for
    bit, every radix kernel launched in each and no plain call."""
    import json
    import subprocess
    import sys
    from dataclasses import asdict, replace

    from chip_smoke import free_port
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from tests.test_torch_multiproc import ROOT

    data = make_corpus(_SESSION_WORDS, _SESSION_WORDS // 27, seed=4)
    corpus = tmp_path / "corpus"
    corpus.write_bytes(data)
    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
    spec = {"radix": {"corpus": str(corpus), "chunk": _FEED_CHUNK,
                      "waves": 2, "device": "cuda", "cfg": asdict(cfg)}}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multiproc", "engine",
         str(r), "2", str(port), json.dumps(spec),
         str(tmp_path / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    metas = [json.loads((tmp_path / f"rank{r}.npz.json").read_text())
             for r in range(2)]
    for f in ("keys", "values", "payload", "valid", "matrix"):
        assert np.array_equal(ranks[0][f"radix.{f}"], ranks[1][f"radix.{f}"])
    res = wcmod.DeviceResult(*(torch.from_numpy(ranks[0][f"radix.{f}"])
                               for f in ("keys", "values", "payload",
                                         "valid")), 0)
    wc = wcmod.DeviceWordCount(wcmod.Partitions(8, "cpu"),
                               chunk_len=_FEED_CHUNK, config=cfg)
    chunks, _ = wc._to_chunks(data)
    assert wcmod.materialize_counts(chunks, res) == Counter(data.split())
    for meta in metas:
        assert not any(meta["radix"]["plain_calls"].values()), meta
        for name in ("tokenize", "segreduce", "radix_plan",
                     "radix_upfront", "radix_onesweep"):
            assert meta["radix"]["launches"][name] > 0, (name, meta)


def _two_ranks(module, mode, *extra, timeout=600):
    """Two gloo ranks of *module*'s ``_main`` in *mode* on this card;
    each rank's output, after both exited 0."""
    import subprocess
    import sys

    from chip_smoke import free_port
    from tests.test_torch_multiproc import ROOT

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, mode, str(r), "2", str(port),
         *[e(r) if callable(e) else e for e in extra]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_two_rank_session_on_the_card(dev, tmp_path):
    """``tests/test_torch_multiproc_session.py``'s scenarios with each
    rank's ``Partitions(8, "cuda", group=WORLD)`` on this card: every
    snapshot, histogram, table and traffic matrix bit-equal on both ranks
    and to one process's on the card, the group's spill files a
    one-process spill's; the segreduce and radix kernels launched in each
    rank and no plain call.  Then its fleet moves (``run_moves``): the
    moved streams' ends bit-equal to one process's on the card, one
    route flip, decision and count, rank 0's."""
    import json
    import os

    from mapreduce_tpu_torch.engine import spill as tspill
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router
    from tests import test_torch_multiproc_session as ms

    _two_ranks("tests.test_torch_multiproc_session", "session",
               str(tmp_path), lambda r: str(tmp_path / f"rank{r}.npz"),
               "cuda")
    one, one_meta = ms.run_scenarios(
        Partitions(ms.P, dev), str(tmp_path / "one"),
        lambda d: tspill.SessionSpillStore(router(f"shared:{d}")))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    metas = [json.loads((tmp_path / f"rank{r}.npz.json").read_text())
             for r in range(2)]
    for name, a in one.items():
        for rk in ranks:
            assert np.array_equal(rk[name], a), name
    ms.check_moves(lambda r: tmp_path / f"rank{r}.npz", metas, one)
    for meta in metas:
        assert not any(meta.pop("plain_calls").values()), meta
        launches = meta.pop("launches")
        # the records map emits its records without the tokenizer
        for name in ("segreduce", "radix_plan", "radix_upfront",
                     "radix_onesweep"):
            assert launches[name] > 0, (name, launches)
        assert meta == json.loads(json.dumps(one_meta))
    gdir, odir = tmp_path / "group" / "spill", tmp_path / "one" / "spill"
    names = sorted(n for n in os.listdir(gdir) if (gdir / n).is_file())
    assert names == sorted(n for n in os.listdir(odir)
                           if (odir / n).is_file())
    for n in names:
        assert (gdir / n).read_bytes() == (odir / n).read_bytes(), n


def test_two_rank_pipeline_on_the_card(dev, tmp_path):
    """``tests/test_torch_multiproc_train.py``'s pipeline cases with both
    ranks' ``PipelinedTrainer(group=WORLD)`` on this card (the boundary
    activations through pinned host memory): the forward, the loss and
    every updated parameter against the one-process trainer's on the
    card, at the CPU test's tolerances."""
    import json

    from tests import test_torch_multiproc_train as mt

    _two_ranks("tests.test_torch_multiproc_train", "pipe",
               lambda r: str(tmp_path / f"pipe{r}.npz"), "cuda")
    ranks = [np.load(tmp_path / f"pipe{r}.npz") for r in range(2)]
    metas = [json.loads((tmp_path / f"pipe{r}.npz.json").read_text())
             for r in range(2)]
    mt.check_pipeline(ranks, metas, mt.one_process_pipeline(dev))


def test_two_rank_ring_on_the_card(dev, tmp_path):
    """The causal ring over 4 partitions across two ranks on this card
    (bf16, 2 partitions a rank, the K/V blocks crossing through pinned
    host memory): each rank's slice of the output and of the q, k, v
    gradients against the one-process ring on the card at the flash
    tolerance; each rank launches each flash kernel once at every ring
    step where one of its query partitions attends (rank 0 at steps 0-1,
    rank 1 at 0-3) and calls no plain version."""
    import json

    from mapreduce_tpu_torch.parallel.ring import ring_attention
    from tests import test_torch_multiproc_train as mt

    _two_ranks("tests.test_torch_multiproc_train", "ring",
               lambda r: str(tmp_path / f"ring{r}.npz"), "cuda")
    q, k, v, do = (t.requires_grad_() if i < 3 else t
                   for i, t in enumerate(mt.ring_inputs(dev)))
    out = ring_attention(q, k, v, 4, causal=True)
    out.backward(do)
    for r in range(2):
        got = np.load(tmp_path / f"ring{r}.npz")
        meta = json.loads((tmp_path / f"ring{r}.npz.json").read_text())
        sl = slice(r * 512, (r + 1) * 512)
        for name, want in (("out", out), ("dq", q.grad), ("dk", k.grad),
                           ("dv", v.grad)):
            _close(torch.from_numpy(got[name]), want[:, sl].detach().cpu(),
                   f"rank {r} {name}")
        kernels = ("flash_fwd", "flash_dq", "flash_dkv")
        assert {n: meta["launches"][n] for n in kernels} == \
            dict.fromkeys(kernels, 2 * (r + 1)), meta
        assert not any(meta["plain_calls"].values()), meta
