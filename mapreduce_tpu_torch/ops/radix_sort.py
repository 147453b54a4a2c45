"""LSD radix sort over the hash-key lanes and the fused partition plan
(port of ``ops/radix_sort.py``).

``radix_sort_pairs(k1, k2) -> (k1s, k2s, perm)``
    Stable least-significant-digit radix sort of the 64-bit key
    ``(k1 hi, k2 lo)`` of uint32 values held as int32 bit patterns,
    bit-identical to ``lax.sort((k1, k2, iota), num_keys=2)`` and so to
    the JAX package's ``radix_sort_pairs``.  It is onesweep: one upfront
    histogram of all eight 8-bit digits (``radix_upfront``), then one
    pass a digit (``radix_onesweep``), four over ``k2`` and then four
    over ``k1``, each ranking its tile, finding the tile's prefix by
    decoupled look-back and scattering.  A stable LSD sort has one output
    permutation whatever its digit width, so the TPU's 4-bit digits in
    16 passes and these 8-bit digits in 8 passes agree bit for bit.  On
    the card the whole sort is one C call (a memset, the upfront kernel
    and 8 onesweep launches on the current stream).

``radix_partition_plan(dest, num_partitions) -> (rank, counts)``
    The exchange's routing plan from one pass over the destination:
    ``rank`` is each row's stable input-order index within its bucket
    (rows of bucket ``P``, the dropped ones, rank among themselves) and
    ``counts`` the rows per destination before capacity capping (the
    traffic-matrix row).  ``dest`` may carry a leading batch axis (one
    plan per source partition).  On the card the plan is one C call (a
    memset and one ``radix_plan`` launch for all rows): each tile ranks
    its rows and finds its prefix by decoupled look-back.

The three kernels live in ``csrc/radix.cu``.  Each has its plain
PyTorch version here, with the kernel's arithmetic: the sort's ``[8,
256]`` upfront table, its passes over tiles of :data:`RADIX_SORT_TILE`
rows (the digit base, the tile prefix in tile order that the look-back
finds, the in-tile stable rank), and the plan as a digit-major
histogram ``[batch, R, tiles]`` over tiles of :data:`RADIX_TILE` rows,
its column scan and the in-tile rank (a one-hot cumsum here, a warp
match there).  :mod:`.kernel_compat`'s rule picks between them by the
tensor's device; on the CPU the sort is these plain passes, never
``torch.sort``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernel_compat as kc

#: digit width of one pass; R = 256 buckets
RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
#: passes over the 64-bit key: 4 over k2, then 4 over k1
RADIX_PASSES = 2 * (32 // RADIX_BITS)
#: ``(lane, shift)`` of each pass: lane 1 is k2, the low word, first
PASSES = tuple((lane, shift) for lane in (1, 0)
               for shift in range(0, 32, RADIX_BITS))
#: rows per tile of the plan (``MR_PLAN_TILE`` of ``csrc/radix.cu``; no
#: output of the plain version depends on it)
RADIX_TILE = 4096
#: rows per tile of the sort's onesweep passes (256 threads x 16 rows)
RADIX_SORT_TILE = 4096
#: the most partitions a plan takes: P + 1 buckets fit one 8-bit digit
MAX_PARTITIONS = RADIX - 1
#: the most rows a sort takes: a look-back word holds a count below 2^30
MAX_SORT_ROWS = (1 << 30) - 1
#: the most rows a plan's batch row takes on the card (rank is int32),
#: and the most batch rows
MAX_PLAN_ROWS = (1 << 31) - 1
MAX_PLAN_BATCH = 65535
#: rows of one-hot rank work per plain-version step (bounds its memory)
_PLAIN_ROWS = 1 << 22


def _tiles(n: int, tile: int = RADIX_TILE) -> int:
    return -(-n // tile)


def _digits(src: torch.Tensor, shift: int, mask: int,
            nbuckets: int) -> torch.Tensor:
    """The kernels' digit: ``(uint32(src) >> shift) & mask``, clamped to
    ``nbuckets - 1``, as int64."""
    d = (kc.u32(src) >> shift) & mask
    return d.clamp(max=nbuckets - 1)


# -- plain versions ------------------------------------------------------------

def _radix_hist_plain(src: torch.Tensor, shift: int, mask: int,
                      nbuckets: int) -> torch.Tensor:
    """``src [b, n]`` -> ``hist [b, nbuckets, tiles]`` int32."""
    b, n = src.shape
    tiles = _tiles(n)
    d = _digits(src, shift, mask, nbuckets)
    tile = torch.arange(n, device=src.device) // RADIX_TILE
    row = torch.arange(b, device=src.device)[:, None] * (nbuckets * tiles)
    flat = (row + d * tiles + tile).reshape(-1)
    hist = torch.zeros(b * nbuckets * tiles, dtype=torch.int32,
                       device=src.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist.reshape(b, nbuckets, tiles)


def _col_scan(hist: torch.Tensor):
    """``(prefix, totals)``: the exclusive scan of each digit's column
    over the tiles, and the column sums ``[b, R]``."""
    cs = torch.cumsum(hist, dim=2, dtype=torch.int32)
    return cs - hist, cs[..., -1]


def _tile_ranks(d: torch.Tensor, nbuckets: int,
                tile: int = RADIX_TILE) -> torch.Tensor:
    """Each row's stable input-order rank among equal digits of its tile
    of *tile* rows: ``d [b, n]`` int64 -> ``[b, n]`` int64, by a one-hot
    cumsum over the tile, a few tiles at a time."""
    b, n = d.shape
    tiles = _tiles(n, tile)
    pad = tiles * tile - n
    # the tail pads with an extra bucket, counted by nothing real
    dp = torch.nn.functional.pad(d, (0, pad), value=nbuckets)
    rows = dp.reshape(b * tiles, tile)
    out = torch.empty_like(rows)
    step = max(1, _PLAIN_ROWS // (tile * (nbuckets + 1)))
    buckets = torch.arange(nbuckets + 1, device=d.device)
    for lo in range(0, rows.shape[0], step):
        r = rows[lo:lo + step]
        csum = torch.cumsum(r[..., None] == buckets, dim=1,
                            dtype=torch.int32)
        out[lo:lo + step] = torch.gather(csum, 2, r[..., None])[..., 0] - 1
    return out.reshape(b, tiles * tile)[:, :n]


def _radix_rank_plain(dest: torch.Tensor, hist: torch.Tensor,
                      nbuckets: int):
    """``(rank [b, n] int32, totals [b, nbuckets] int32)``."""
    b, n = dest.shape
    prefix, totals = _col_scan(hist)
    d = _digits(dest, 0, kc.MASK32, nbuckets)
    tile = (torch.arange(n, device=dest.device) // RADIX_TILE).expand(b, n)
    off = prefix[torch.arange(b, device=dest.device)[:, None], d, tile]
    rank = off.to(torch.int64) + _tile_ranks(d, nbuckets)
    return rank.to(torch.int32), totals


def _radix_plan_plain(dest: torch.Tensor, nbuckets: int):
    """The plan of ``dest [b, n]`` int32 over *nbuckets* buckets: ``(rank
    [b, n], totals [b, nbuckets])`` int32, from the histogram and the
    ranks above."""
    hist = _radix_hist_plain(dest, 0, kc.MASK32, nbuckets)
    return _radix_rank_plain(dest, hist, nbuckets)


def _pass_digits(k1: torch.Tensor, k2: torch.Tensor, lane: int,
                 shift: int) -> torch.Tensor:
    """The 8-bit digit at *shift* of k1 (lane 0) or k2 (lane 1), int64."""
    return _digits(k2 if lane else k1, shift, RADIX - 1, RADIX)


def _radix_upfront_plain(k1: torch.Tensor, k2: torch.Tensor
                         ) -> torch.Tensor:
    """``table [8, 256]`` int32: row p counts the rows by their pass-p
    digit (:data:`PASSES`)."""
    return torch.stack([
        torch.bincount(_pass_digits(k1, k2, lane, shift), minlength=RADIX)
        for lane, shift in PASSES]).to(torch.int32)


def _radix_onesweep_plain(k1: torch.Tensor, k2: torch.Tensor,
                          perm: Optional[torch.Tensor], lane: int,
                          shift: int, counts: torch.Tensor, out) -> None:
    """One stable pass into *out* ``(o1, o2, operm)``, from the pass's
    digit counts ``[256]``: a row goes to its digit's base (the exclusive
    scan of *counts*), plus the rows of its digit in the tiles before its
    own (the look-back's prefix, in tile order), plus its stable rank in
    its tile."""
    n = k1.shape[0]
    d = _pass_digits(k1, k2, lane, shift)
    tile = torch.arange(n, device=k1.device) // RADIX_SORT_TILE
    tiles = _tiles(n, RADIX_SORT_TILE)
    hist = torch.zeros(tiles * RADIX, dtype=torch.int64, device=k1.device)
    hist.index_add_(0, tile * RADIX + d, torch.ones_like(d))
    hist = hist.reshape(tiles, RADIX)
    prefix = torch.cumsum(hist, dim=0) - hist
    counts = counts.to(torch.int64)
    base = torch.cumsum(counts, dim=0) - counts
    pos = (base[d] + prefix[tile, d]
           + _tile_ranks(d[None], RADIX, RADIX_SORT_TILE)[0])
    if perm is None:
        perm = torch.arange(n, dtype=torch.int32, device=k1.device)
    for src, dst in zip((k1, k2, perm), out):
        dst[pos] = src


def _radix_sort_plain(k1: torch.Tensor, k2: torch.Tensor):
    """The plain sort of non-empty int32 ``(k1, k2)``: the upfront table
    and 8 plain passes, two buffer sets alternating as pass outputs (the
    CPU sort; a card run times and checks it on CUDA tensors)."""
    n = k1.shape[0]
    table = _radix_upfront_plain(k1, k2)
    bufs = [tuple(torch.empty(n, dtype=torch.int32, device=k1.device)
                  for _ in range(3)) for _ in range(2)]
    a = (k1, k2, None)
    for p, (lane, shift) in enumerate(PASSES):
        out = bufs[p % 2]
        _radix_onesweep_plain(*a, lane, shift, table[p], out)
        a = out
    return a


# -- kernels -------------------------------------------------------------------

_SIGNATURES = {
    "mr_radix_tile": (ctypes.c_int, []),
    "mr_radix_sort_tile": (ctypes.c_int, []),
    "mr_radix_pass_scratch_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "mr_radix_sort_scratch_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "mr_radix_plan_scratch_words": (ctypes.c_longlong,
                                    [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int]),
    "mr_radix_plan": (ctypes.c_int,
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 4),
    "mr_radix_upfront": (ctypes.c_int,
                         [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                         + [ctypes.c_void_p] * 2),
    "mr_radix_onesweep": (ctypes.c_int,
                          [ctypes.c_void_p] * 3
                          + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                          + [ctypes.c_void_p] * 6),
    "mr_radix_sort_pairs": (ctypes.c_int,
                            [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                            + [ctypes.c_void_p] * 8),
}


def _lib():
    lib = kc.library("radix", _SIGNATURES)
    for got, want, what in ((lib.mr_radix_tile(), RADIX_TILE, "plan"),
                            (lib.mr_radix_sort_tile(), RADIX_SORT_TILE,
                             "sort")):
        if got != want:
            raise RuntimeError(f"csrc/radix.cu tiles the {what} by {got} "
                               f"rows, the wrappers assume {want}")
    return lib


def _radix_plan_cuda(dest: torch.Tensor, nbuckets: int):
    """The plan in one C call: a memset of the look-back scratch and one
    launch of ``plan_kernel`` over every tile of every batch row."""
    dev = dest.device
    b, n = dest.shape
    if n > MAX_PLAN_ROWS:
        raise ValueError(f"radix_plan: at most {MAX_PLAN_ROWS} rows a batch "
                         f"row (the rank is int32), got {n}")
    if b > MAX_PLAN_BATCH:
        raise ValueError(f"radix_plan: at most {MAX_PLAN_BATCH} batch rows, "
                         f"got {b}")
    kc.require(dest, "radix_plan", "dest", torch.int32, dev)
    lib = _lib()
    scratch = torch.empty(lib.mr_radix_plan_scratch_words(n, b, nbuckets),
                          dtype=torch.int32, device=dev)
    rank = torch.empty_like(dest)
    totals = torch.empty((b, nbuckets), dtype=torch.int32, device=dev)
    err = lib.mr_radix_plan(kc.ptr(dest), n, b, nbuckets, kc.ptr(scratch),
                            kc.ptr(rank), kc.ptr(totals), kc.stream(dev))
    kc.check("radix_plan", err)
    kc.count_launch("radix_plan")
    return rank, totals


def _check_sort_rows(n: int, kernel: str) -> None:
    if n > MAX_SORT_ROWS:
        raise ValueError(f"{kernel}: at most {MAX_SORT_ROWS} rows (a "
                         f"look-back word holds 30 bits of count), got {n}")


def _radix_upfront_cuda(k1: torch.Tensor, k2: torch.Tensor
                        ) -> torch.Tensor:
    dev = k1.device
    n = k1.shape[0]
    _check_sort_rows(n, "radix_upfront")
    for name, t in (("k1", k1), ("k2", k2)):
        kc.require(t, "radix_upfront", name, torch.int32, dev, (n,))
    table = torch.empty((RADIX_PASSES, RADIX), dtype=torch.int32,
                        device=dev)
    err = _lib().mr_radix_upfront(kc.ptr(k1), kc.ptr(k2), n, kc.ptr(table),
                                  kc.stream(dev))
    kc.check("radix_upfront", err)
    kc.count_launch("radix_upfront")
    return table


def _radix_onesweep_cuda(k1: torch.Tensor, k2: torch.Tensor,
                         perm: Optional[torch.Tensor], lane: int, shift: int,
                         counts: torch.Tensor, out) -> None:
    dev = k1.device
    n = k1.shape[0]
    _check_sort_rows(n, "radix_onesweep")
    lanes = [("k1", k1), ("k2", k2)] + [
        (f"out[{i}]", o) for i, o in enumerate(out)]
    if perm is not None:
        lanes.append(("perm", perm))
    for name, t in lanes:
        kc.require(t, "radix_onesweep", name, torch.int32, dev, (n,))
    kc.require(counts, "radix_onesweep", "counts", torch.int32, dev,
               (RADIX,))
    lib = _lib()
    scratch = torch.empty(lib.mr_radix_pass_scratch_words(n),
                          dtype=torch.int32, device=dev)
    err = lib.mr_radix_onesweep(
        kc.ptr(k1), kc.ptr(k2), kc.ptr(perm) if perm is not None else None,
        n, lane, shift, kc.ptr(counts), kc.ptr(scratch),
        *(kc.ptr(o) for o in out), kc.stream(dev))
    kc.check("radix_onesweep", err)
    kc.count_launch("radix_onesweep")


def _radix_sort_cuda(k1: torch.Tensor, k2: torch.Tensor):
    """The whole sort in one C call: a memset of the scratch, the upfront
    kernel and the 8 onesweep launches, two buffer sets alternating."""
    dev = k1.device
    n = k1.shape[0]
    _check_sort_rows(n, "radix_sort_pairs")
    for name, t in (("k1", k1), ("k2", k2)):
        kc.require(t, "radix_sort_pairs", name, torch.int32, dev, (n,))
    lib = _lib()
    a = torch.empty((3, n), dtype=torch.int32, device=dev)
    b = torch.empty((3, n), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mr_radix_sort_scratch_words(n),
                          dtype=torch.int32, device=dev)
    err = lib.mr_radix_sort_pairs(
        kc.ptr(k1), kc.ptr(k2), n, *(kc.ptr(t) for t in a),
        *(kc.ptr(t) for t in b), kc.ptr(scratch), kc.stream(dev))
    kc.check("radix_sort_pairs", err)
    kc.count_launch("radix_upfront")
    kc.count_launch("radix_onesweep", RADIX_PASSES)
    return b[0], b[1], b[2]


# -- the wrappers: the kernel on CUDA, the plain version on the CPU -----------

def radix_sort_pairs(k1: torch.Tensor, k2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable radix sort by ``(k1 hi, k2 lo)`` as uint32: ``(k1s, k2s,
    perm)`` with int32 lanes, bit-identical to ``lax.sort((k1, k2,
    iota), num_keys=2)``.  On the card: one C call that enqueues the
    whole sort on the current stream with no host sync; on the CPU: the
    plain upfront table and passes (:func:`_radix_sort_plain`), counted
    as the card counts its launches (one upfront, 8 onesweep)."""
    if k1.shape[0] == 0:
        return k1, k2, torch.zeros(0, dtype=torch.int32, device=k1.device)
    k1 = k1.to(torch.int32).contiguous()
    k2 = k2.to(torch.int32).contiguous()
    if kc.use_kernel(k1, "radix_upfront"):
        return _radix_sort_cuda(k1, k2)
    kc.count_plain("radix_onesweep", RADIX_PASSES)
    return _radix_sort_plain(k1, k2)


def radix_partition_plan(dest: torch.Tensor, num_partitions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exchange's plan.  ``dest`` is int32 in ``[0, P]`` (``P`` marks a
    dropped row; anything outside clamps to ``P``), shaped ``[n]`` or
    ``[b, n]`` (one plan per row).  Returns ``(rank, counts)``: ``rank``
    like ``dest``, each row's stable index within its bucket; ``counts``
    ``[P]`` or ``[b, P]``, rows per destination before capping.  On the
    card: one C call on the current stream with no host sync, which takes
    at most :data:`MAX_PLAN_BATCH` rows of at most :data:`MAX_PLAN_ROWS`;
    on the CPU: :func:`_radix_plan_plain`."""
    P = int(num_partitions)
    if not 1 <= P <= MAX_PARTITIONS:
        raise ValueError(f"radix_partition_plan takes 1..{MAX_PARTITIONS} "
                         f"partitions (P + 1 buckets in one 8-bit digit), "
                         f"got {P}")
    squeeze = dest.dim() == 1
    d2 = (dest[None] if squeeze else dest).to(torch.int32).contiguous()
    b, n = d2.shape
    if d2.numel() == 0:
        rank = torch.zeros((b, n), dtype=torch.int32, device=dest.device)
        counts = torch.zeros((b, P), dtype=torch.int32, device=dest.device)
    else:
        if kc.use_kernel(d2, "radix_plan"):
            rank, totals = _radix_plan_cuda(d2, P + 1)
        else:
            rank, totals = _radix_plan_plain(d2, P + 1)
        counts = totals[:, :P]
    return (rank[0], counts[0]) if squeeze else (rank, counts)
