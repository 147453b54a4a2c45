"""The port's tokenizer (mapreduce_tpu_torch/ops/tokenize.py) against the
JAX package's, bit for bit.

The port's plain PyTorch version (what a CPU tensor runs; the CUDA kernel
is held against it on the card in test_torch_cuda.py) must give the JAX
Pallas kernel's TokenStream — run here in interpret mode — and its lax
formulation's, field for field, plus the host twin's word hashes.  Inputs
are made with numpy from fixed seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapreduce_tpu.ops import tokenize as jtok
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import tokenize as ttok

M2 = (ttok.HASH_A1, ttok.HASH_A2)
M3 = (ttok.HASH_A1, ttok.HASH_A2, ttok.HASH_A3)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    vocab = [b"a", b"of", b"parliament", b"\xc3\xa9t\xc3\xa9", b"word,",
             b"\xe2\x82\xac5", b"x" * 150]
    seps = [b" ", b"\n", b"\t", b"  \r\n", b"\x0b", b"\x0c"]
    out = b""
    while len(out) < n:
        out += vocab[int(rng.integers(0, len(vocab)))]
        out += seps[int(rng.integers(0, len(seps)))]
    return out[:n]


def _pin(port, ref, ctx):
    """A port TokenStream equals a JAX one on all four fields."""
    assert np.array_equal(port.is_end.numpy(), np.asarray(ref.is_end)), ctx
    assert np.array_equal(port.keys.numpy().view(np.uint32),
                          np.asarray(ref.keys)), ctx
    assert np.array_equal(port.start.numpy(), np.asarray(ref.start)), ctx
    assert np.array_equal(port.length.numpy(), np.asarray(ref.length)), ctx


CASES = {
    # non-block-multiple lengths, words across the 4096-byte block edge
    "mixed-2-lanes": (_words(9000, 1), M2),
    "mixed-3-lanes": (_words(5000, 2), M3),
    "whitespace-only": (b" \t\n\r\x0b\x0c" * 700, M2),
    "word-at-0-and-to-the-end": (b"first" + b" " * 4090 + b"lastword", M2),
    "word-across-block": (b" " * 4090 + b"straddling-word" + b" x", M2),
    "utf8": ("naïve café 数据 Ωmega ".encode() * 300, M2),
    # the carry chains of the card kernel's look-back: one word over five
    # 4096-byte blocks, and a word, a whitespace run longer than a block
    # (no word starts in it) and a word
    "one-word-20000": (b"w" * 20_000, M2),
    "word-long-space-run-word": (b"first" + b" \t" * 5000 + b"last", M3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tokenize_plain_matches_jax_pallas_and_lax(name):
    text, mults = CASES[name]
    arr = np.frombuffer(text, dtype=np.uint8)
    port = ttok.tokenize_hash(torch.from_numpy(arr.copy()), mults)
    pallas = jtok.tokenize_hash(jnp.asarray(arr), mults, impl="pallas",
                                interpret=True)
    _pin(port, pallas, (name, "pallas"))
    lax = jtok.tokenize_hash(jnp.asarray(arr), mults, impl="lax")
    _pin(port, lax, (name, "lax"))


def test_tokenize_plain_matches_host_twin():
    text = _words(20000, 7)
    toks = ttok.tokenize_hash(
        torch.from_numpy(np.frombuffer(text, dtype=np.uint8).copy()))
    want = ttok.word_hashes_host(text)
    assert want == jtok.word_hashes_host(text)
    ends = torch.nonzero(toks.is_end).reshape(-1).tolist()
    assert len(ends) == len(text.split())
    keys = toks.keys.numpy().view(np.uint32)
    for i in ends:
        s = int(toks.start[i])
        assert int(toks.length[i]) == i - s + 1
        assert want[text[s:i + 1]] == tuple(int(v) for v in keys[i])


def test_uint32_helpers_pinned():
    """int64-held uint32 arithmetic: the split multiply wraps exactly like
    Python's masked products, across the sign-bit and wraparound edges,
    and reproduces word_hashes_host's rolling hash."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 2 ** 32, 500),
                         [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]])
    for a in (ttok.HASH_A1, ttok.HASH_A2, ttok.HASH_A3, 2 ** 32 - 1):
        got = kc.mul_u32(torch.from_numpy(xs.astype(np.int64)), a)
        assert got.tolist() == [(int(x) * a) & 0xFFFFFFFF for x in xs]
        # tensor multiplier too
        at = torch.full((xs.size,), a, dtype=torch.int64)
        assert torch.equal(kc.mul_u32(torch.from_numpy(xs), at), got)
    bits = kc.as_i32(torch.from_numpy(xs.astype(np.int64)))
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32),
                          xs.astype(np.uint32))
    assert torch.equal(kc.u32(bits), torch.from_numpy(xs.astype(np.int64)))
    for w in (b"europarl", b"\xff" * 9, b"a"):
        h = torch.zeros((), dtype=torch.int64)
        for b in w:
            h = (kc.mul_u32(h, ttok.HASH_A2) + b + 1) & kc.MASK32
        assert int(h) == ttok.word_hashes_host(w)[w][1]


def test_tokenize_cpu_takes_plain_version_and_counts_it():
    kc.reset_counts()
    ttok.tokenize_hash(torch.zeros(16, dtype=torch.uint8))
    assert kc.PLAIN_CALLS["tokenize"] == 1
    assert kc.LAUNCHES["tokenize"] == 0
    with pytest.raises(ValueError):
        ttok.tokenize_hash(torch.zeros(16, dtype=torch.uint8), impl="mosaic")


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_text_matches_jax(shards):
    text = _words(3000, shards)
    a = ttok.shard_text(text, shards, pad_multiple=128, return_offsets=True,
                        pad_to=512)
    b = jtok.shard_text(text, shards, pad_multiple=128, return_offsets=True,
                        pad_to=512)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert np.array_equal(a[2], b[2])
