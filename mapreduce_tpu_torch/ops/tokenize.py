"""Byte-stream tokenizer + word hasher (the port of ``ops/tokenize.py``).

The raw UTF-8 bytes of a chunk go to the device as one ``[L] uint8``
tensor and one pass computes, per byte position, whether a word ends
there, the polynomial hash lanes of the word ending there, and where its
bytes start.  The rolling-hash step ``h_i = a*h_{i-1} + (b_i+1)`` is the
affine map ``h -> m*h + c`` with ``(m, c) = (a, b_i+1)`` on word bytes and
``(0, 0)`` on whitespace (which also resets it), so the whole stream is a
scan of affine maps.

Whitespace is ASCII {space, \\t, \\n, \\r, \\f, \\v}, matching Python's
``bytes.split()``; multi-byte UTF-8 sequences are word bytes.

:func:`tokenize_hash` follows :mod:`.kernel_compat`'s one rule: a chunk on
a CUDA device launches the hand-written kernel (``csrc/tokenize.cu``), a
chunk on the CPU runs :func:`_tokenize_plain`.  Hash lanes are uint32
values carried as **int32 bit patterns**: ``keys.numpy().view(np.uint32)``
gives the JAX package's values.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import kernel_compat as kc

#: polynomial multipliers for the two 32-bit hash lanes (the JAX
#: package's constants: FNV prime and a Murmur3 finalizer constant)
HASH_A1 = 16777619
HASH_A2 = 0x85EBCA6B
#: third, independent lane used only by collision-verify mode
HASH_A3 = 0xCC9E2D51

_WS = (32, 9, 10, 13, 12, 11)


class TokenStream(NamedTuple):
    """Per-byte-position token info (fixed shape [L])."""

    is_end: torch.Tensor  # [L] bool — a word's last byte is here
    keys: torch.Tensor    # [L, n_lanes] int32 — uint32 hash lanes as bits
    start: torch.Tensor   # [L] int32 — byte offset where that word starts
    length: torch.Tensor  # [L] int32 — word length in bytes


def _is_space(chunk: torch.Tensor) -> torch.Tensor:
    m = chunk == _WS[0]
    for w in _WS[1:]:
        m = m | (chunk == w)
    return m


def _affine_scan(m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of affine maps ``h -> m*h + c`` (uint32 as int64);
    returns the composed ``c`` lane, i.e. ``h`` at each position with
    ``h = 0`` before the sequence.  A Hillis-Steele ladder of shifted
    compositions: ``log2(L)`` passes, exact in wraparound arithmetic."""
    L = m.shape[0]
    d = 1
    while d < L:
        ml = torch.cat([torch.ones(d, dtype=m.dtype, device=m.device),
                        m[:-d]])
        cl = torch.cat([torch.zeros(d, dtype=c.dtype, device=c.device),
                        c[:-d]])
        # the left map happens first: (ml, cl) then (m, c)
        m, c = kc.mul_u32(m, ml), (kc.mul_u32(cl, m) + c) & kc.MASK32
        d *= 2
    return c


def _tokenize_plain(chunk: torch.Tensor, multipliers) -> TokenStream:
    """The plain PyTorch version of the kernel (same outputs, bit for
    bit): byte classify, one affine ladder per hash lane, and a running
    max of word-start positions."""
    L = chunk.shape[0]
    dev = chunk.device
    space = _is_space(chunk)
    word = ~space
    one = torch.ones(1, dtype=torch.bool, device=dev)
    # the chunk end and the byte before it count as whitespace
    is_end = word & torch.cat([space[1:], one])
    is_start = word & torch.cat([one, space[:-1]])
    b = chunk.to(torch.int64)
    keys = []
    for a in multipliers:
        m = torch.where(word, int(a) & kc.MASK32, 0)
        c = torch.where(word, b + 1, 0)
        keys.append(kc.as_i32(_affine_scan(m, c)))
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    marks = torch.where(is_start, pos, -1)
    start = torch.cummax(marks, dim=0).values
    length = pos - start + 1
    return TokenStream(is_end=is_end, keys=torch.stack(keys, dim=-1),
                       start=start, length=length)


_SIGNATURES = {
    "mr_tokenize_scratch_bytes": (ctypes.c_longlong,
                                  [ctypes.c_int, ctypes.c_int]),
    "mr_tokenize": (ctypes.c_int,
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
                    + [ctypes.c_void_p] * 6),
}


def _tokenize_cuda(chunk: torch.Tensor, multipliers) -> TokenStream:
    """Launch ``csrc/tokenize.cu`` (the port of ``_tokenize_kernel``)."""
    dev = chunk.device
    kc.require(chunk, "tokenize", "chunk", torch.uint8, dev)
    n, nl = chunk.shape[0], len(multipliers)
    if not 1 <= nl <= 3:
        raise ValueError(f"tokenize kernel takes 1-3 hash lanes, got {nl}")
    keys = torch.empty((n, nl), dtype=torch.int32, device=dev)
    is_end = torch.empty(n, dtype=torch.bool, device=dev)
    start = torch.empty(n, dtype=torch.int32, device=dev)
    length = torch.empty(n, dtype=torch.int32, device=dev)
    lib = kc.library("tokenize", _SIGNATURES)
    scratch = torch.empty(lib.mr_tokenize_scratch_bytes(n, nl),
                          dtype=torch.uint8, device=dev)
    a = [int(x) & kc.MASK32 for x in multipliers] + [0] * (3 - nl)
    err = lib.mr_tokenize(kc.ptr(chunk), n, nl, a[0], a[1], a[2],
                          kc.ptr(keys), kc.ptr(is_end), kc.ptr(start),
                          kc.ptr(length), kc.ptr(scratch), kc.stream(dev))
    kc.check("tokenize", err)
    kc.count_launch("tokenize")
    return TokenStream(is_end, keys, start, length)


def tokenize_hash(chunk: torch.Tensor, multipliers=(HASH_A1, HASH_A2),
                  impl: str = "lax") -> TokenStream:
    """Tokenize one padded byte chunk ``[L] uint8``.

    *multipliers* selects the polynomial hash lanes (collision-verify
    mode passes a third).  *impl* is the JAX package's formulation name
    ('lax' or 'pallas'), validated so configurations carry over; which
    code runs is decided by the chunk's device alone (the kernel on CUDA,
    the plain version on the CPU)."""
    if impl not in ("lax", "pallas"):
        raise ValueError(f"tokenize impl must be 'lax' or 'pallas', "
                         f"got {impl!r}")
    multipliers = tuple(multipliers)
    if kc.use_kernel(chunk, "tokenize"):
        return _tokenize_cuda(chunk, multipliers)
    return _tokenize_plain(chunk, multipliers)


# --- host twins (oracle + final key materialisation) -------------------------

def word_hashes_host(text: bytes) -> dict:
    """Pure-Python twin of :func:`tokenize_hash`: {word_bytes: (h1, h2)}
    as unsigned ints."""
    out = {}
    for w in text.split():
        h1 = h2 = 0
        for byte in w:
            h1 = (h1 * HASH_A1 + byte + 1) & 0xFFFFFFFF
            h2 = (h2 * HASH_A2 + byte + 1) & 0xFFFFFFFF
        out[w] = (h1, h2)
    return out


def shard_text(data: bytes, num_shards: int, pad_multiple: int = 128,
               return_offsets: bool = False, pad_to: int = None):
    """Split a text blob into ``num_shards`` roughly equal byte chunks on
    whitespace boundaries, space-padded to one common length (a multiple
    of *pad_multiple*, at least *pad_to*).  Returns ``(chunks [S, L]
    uint8, L)`` or, with *return_offsets*, ``(chunks, L, starts [S]
    int64)``.  Splitting only at whitespace keeps every word inside
    exactly one chunk."""
    n = len(data)
    flat = np.frombuffer(data, dtype=np.uint8)
    bounds = [0]
    for s in range(1, num_shards):
        cut = min(n, s * n // num_shards)
        while cut < n and data[cut] not in _WS:
            cut += 1
        bounds.append(cut)
    bounds.append(n)
    L = max(1, max(bounds[i + 1] - bounds[i] for i in range(num_shards)))
    if pad_to is not None:
        L = max(L, pad_to)
    L = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    arr = np.full((num_shards, L), ord(" "), dtype=np.uint8)
    for i in range(num_shards):
        lo, hi = bounds[i], bounds[i + 1]
        arr[i, :hi - lo] = flat[lo:hi]
    if return_offsets:
        return arr, L, np.asarray(bounds[:-1], dtype=np.int64)
    return arr, L
