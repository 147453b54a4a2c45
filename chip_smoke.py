#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (mapreduce_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and in a directory
that holds this script and nothing else of the repo).  Phases, each of
which raises on failure:

1. build the CUDA kernels from ``mapreduce_tpu_torch/csrc`` (one nvcc per
   source and one per variant of a tile size for the A/Bs of phases 2, 3
   and 6, all started together), print each kernel's registers and
   spill bytes as ptxas reports them (``ptxas`` line; a flash, onesweep,
   plan, tokenize or segreduce kernel that spills fails the run) and
   the card's name and power limit;
2. the tokenize kernel against its plain PyTorch version on one
   full-width chunk (4,194,816 bytes of the synthetic corpus): bit
   equality, then kernel / plain times beside the memory bound (the
   kernel as 20 launches replayed from one CUDA graph, see
   :func:`kernel_ms`), an A/B of its tile size (variant builds with
   ``-DMR_TOKENIZE_TILE``, each bit-equal, timed in turns) and one call
   captured in a CUDA graph and replayed 50 times, every output
   bit-equal to the first;
3. the segmented-reduce kernel against its plain version at the main
   path's shapes (the per-chunk combiner, the local reduce, the fold,
   and the 3-lane collision-verify monoid), with the same timings, tile
   A/B (``-DMR_SEGREDUCE_TILE``) and replay check for each shape, the
   time of the wrapper's packing of the value lanes alone, and
   ``torch.unique_consecutive`` as the library yardstick of the unit
   case (timed here only; the port never calls it);
4. the slice: ``DeviceWordCount(device="cuda", chunk_len=1<<22,
   config=bench_engine_config())`` over 16M words of the synthetic
   Europarl-shaped corpus (24 chunks, two 12-chunk waves, so the
   accumulator carries across waves), counts held against
   ``collections.Counter(data.split())``, launch counters read around
   each run: first the flagship bench's staged path (``stage``, timed
   as ``ingress_s`` with residency included, ``warm``, then
   ``count_staged``: no ``upload_s``, and ``memory_allocated()`` falls
   by the staged bytes once the handle is consumed; the ``staged``
   line), then the streaming ``count_bytes`` (input bytes held at once
   at most ``STREAM_PREFETCH`` waves); then a small collision-verify
   count;
5. one more slice run under ``torch.profiler``: device time and events
   by group (the kernels, the library sort, host-to-device copies,
   memsets, the rest), counted over device-side events only, and the
   device busy share (device time over the profiled run's wall time, a
   floor, since the profiler lengthens that wall time); each tokenize
   and segreduce wrapper call (and, in phase 7, each exchange plan) must
   show as exactly one kernel event; from the run's Chrome trace, every
   host-to-device copy must be pinned (``Memcpy HtoD (Pinned ->
   Device)``) and on another stream than the kernels (the ``*_upload``
   line: the copies' device ms and the share overlapping kernel time);
6. the radix kernels against their plain versions on inputs the radix
   path makes from the corpus: ``radix_sort_pairs`` (one C call: a
   memset, the upfront kernel and 8 onesweep passes) at the combiner's
   852,072 rows, the local sort's 262,144 and the fold's 1,310,720, also
   against ``torch.sort``'s stable permutation of the packed key (the
   library yardstick), with the function bound (20 B a row), the
   traffic bound (196 B a row), the tile count and an A/B of the sort's
   tile size (variant builds, timed in turns); the fold-shape sort
   replayed 50 times from one CUDA graph, every output bit-equal to the
   first; the upfront kernel and one onesweep pass at the combiner and
   fold shapes; and ``radix_partition_plan`` over ``[8, 262,144]`` with
   9 buckets (one C call: a memset and ``plan_kernel``): kernel, plain
   and library (``torch.bincount``, the counts alone) times beside the
   memory bound, 50 replays from one CUDA graph bit-equal, and an A/B
   of the plan's tile size (variant builds with ``-DMR_PLAN_TILE``);
7. the radix slice: ``DeviceWordCount(Partitions(8, "cuda"),
   chunk_len=1<<22, config=replace(bench_engine_config(),
   sort_impl="radix"))`` over the same corpus with ``waves=2``: counts
   against ``Counter(data.split())``, the 8 x 8 traffic matrix against
   ``host_exchange_matrix``, launches of all five kernels (8 onesweep
   launches for each upfront one: a sort is one C call) and no plain
   call, then a profiled run (no ``torch.sort`` device time) and a run
   under a ``plan_rebalance`` partition map (same counts, the matrix
   against the host recompute under that table); then the tier policy
   ``sort_impl='tiered-radix'`` at the same shape (the ``tiered``
   line): (a) warm, tier ``radix`` from the first wave, no swap, the
   radix kernels launched; (b) under ``tiering.force_cold()``, wave 0
   on tier 0 (``torch.sort`` calls, no radix launch), at most one swap,
   then, once the specializer is done, a run served by ``radix``; (c)
   truly cold: ``python3 chip_smoke.py --cold tiered-radix`` and
   ``--cold radix`` each in a subprocess with an empty temporary
   ``kernel_compat.BUILD_DIR`` over 1M words (``first_dispatch_s`` and
   each library's build seconds); counts and matrices equal everywhere,
   and no tier-1 build may fail;
8. the resident sessions (``EngineSession``, the ``session`` line), launch
   counters read around each part, every kernel of its path launched and
   no plain call: (a) ``bench.py``'s ``measure_sustained`` at full size
   (its config, 1<<20-byte chunks, three tenants fed a 1.5M-word corpus
   each, seeds 0-2, 3 interleaved rounds after a warm feed) at P = 1 and
   at P = 8 on the radix path; after every feed the tenant's snapshot
   equals ``Counter`` of its own words times its feeds; each tenant's
   first feed and snapshot, then 6 rounds alternating one overflow read
   a feed (the port's) with one after every wave (the JAX feed's sync,
   by a wrapper of the engine's wave here); records/s over each mode's
   feeds, feed wall p50/p99, snapshot seconds, staleness (feed end to
   snapshot end, also after the window), resident bytes a stream and
   the peak a feed adds; (b) the flagship config as a session at P = 8, radix,
   with a partition map: the 24 chunks in 4 feeds, a ``plan_rebalance``
   of the stream's bucket histogram after the first, the last two feeds
   profiled (uploads pinned and off the kernels' stream); counts against
   ``Counter``, the traffic matrix against the host recompute under the
   two tables; an evict to ``mem:`` storage and the lazy restore of the
   next snapshot, bit-equal (``session_spill_s``,
   ``session_restore_s``), and ``SpillPolicy(max_resident=1)`` evicting
   the colder stream; (c) ``TopKWords(k=100)`` over the corpus in 4
   feeds, equal to ``host_topk``;
9. the flash-attention kernels against their plain versions on the card
   at the transformer slice's shape ``[4, 8, 2048, 128]`` bf16 causal,
   plus a full (non-causal) case and a ragged ``T = 2000``, ``D = 64``
   case: out, lse, dq, dk and dv; kernel, plain and bound times at the
   slice's shape, and ``F.scaled_dot_product_attention`` as the library
   yardstick: its forward for ``flash_fwd``, its backward alone (one
   call for dq, dk and dv; its device time under the profiler) for
   ``flash_dq`` and ``flash_dkv``, and
   forward + backward (timed here only; the port never calls it); then
   the three kernels once more without the causal mask and with 4x the
   batch (``flash_scaling``: what bounds them);
10. the transformer slice: ``TransformerTrainer`` at the configuration of
   ``bench_train.bench_transformer`` (vocab 32768, embed 1024, 8 layers,
   8 heads x 128, ffn 4096, bf16 products on f32 parameters, B = 4, T =
   2048, SGD at lr 1e-3) on ``np.random.default_rng(0)`` tokens: a first
   step (loss within 2 of ln(32768) + s2/2, s2 the variance of the
   step-0 logits over the vocabulary) held against the same step with the
   flash wrappers swapped for their plain versions, then 5 timed steps
   with launch counters read around them (all three flash kernels
   launched, no plain call), step seconds, tokens/s and MFU, one step
   under ``torch.profiler``, and the logits product's cost three ways
   (bf16 operands with an f32 result, the port's; bf16 result; f32);
11. one JSON line of per-kernel numbers, then the result line.

The word-count comparisons are integer and exact (tolerance: none).  The
flash kernels sum in another order than their plain versions: out, dq,
dk and dv (bf16) are held to atol = rtol = 2e-2 and lse (f32) to atol
1e-3; the trainer's first step to a loss within 1e-2 and each
parameter's update within 5e-2 of its norm.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

#: the card's published memory rate (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 ALU rate taken as the fp32 non-tensor peak (H100 SXM, 67 TFLOP/s)
INT_OPS_PER_S = 67e12
#: dense bf16 tensor-core rate (H100 SXM data sheet, 989 TFLOP/s)
BF16_FLOPS_PER_S = 989e12
CHUNK_LEN = 1 << 22
#: words of the smoke corpus: 24 chunks of 1<<22 bytes (a cut of
#: Europarl's 49M words to fit the smoke's time limit)
N_WORDS = 16_000_000
REPS = 20
#: the radix slice: partitions on the one card, and waves
RADIX_PARTS = 8
RADIX_WAVES = 2
#: the kernels of the word-count slices (phases 4 and 7)
WORDCOUNT_KERNELS = ("tokenize", "segreduce", "radix_plan", "radix_upfront",
                     "radix_onesweep")
#: the sort's tile sizes timed against each other (phase 6): the build's
#: own and variant builds of csrc/radix.cu with MR_ONESWEEP_TILE
SORT_TILE_AB = (1024, 2048, 4096)
#: the exchange plan's tile sizes timed against each other (phase 6): the
#: source's own and a variant build of csrc/radix.cu with MR_PLAN_TILE
PLAN_TILE_AB = (2048, 4096)
#: replays of one captured call in each determinism check (the radix
#: sort and plan, tokenize, segreduce)
REPLAYS = 50
#: the tile sizes of the tokenize and segreduce A/Bs (phases 2-3): the
#: source's own build and variant builds with its define set to each other
#: size
SCAN_TILE_AB = (1024, 2048, 4096)
SCAN_TILE_DEFINES = {"tokenize": "MR_TOKENIZE_TILE",
                     "segreduce": "MR_SEGREDUCE_TILE"}
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: the transformer slice: bench_train.bench_transformer's model and batch
TF_CONFIG = dict(vocab=32768, embed=1024, n_layers=8, n_heads=8,
                 head_dim=128, ffn=4096)
TF_B, TF_T, TF_LR, TF_STEPS = 4, 2048, 1e-3, 5
#: tolerances of the flash kernels against their plain versions
FLASH_TOL = dict(atol=2e-2, rtol=2e-2)
LSE_ATOL = 1e-3
#: the trainer's first step through the kernels against the plain one
STEP_LOSS_ATOL = 1e-2
STEP_UPDATE_RTOL = 5e-2
#: the sustained session (phase 8): bench.py's measure_sustained at its
#: full size (smoke=False): its config, 1<<20-byte chunks, a 1.5M-word
#: make_corpus slice a tenant (seeds 0-2, so tenants that mixed would
#: show), three tenants, 3 rounds a block
SESSION_CONFIG = dict(local_capacity=1 << 17, exchange_capacity=1 << 15,
                      out_capacity=1 << 17, tile=512, tile_records=104,
                      combine_in_scan=True, combine_capacity=1 << 17,
                      unit_values=True, reduce_op="sum")
SESSION_CHUNK_LEN = 1 << 20
SESSION_WORDS = 1_500_000
SESSION_TENANTS = ("t0", "t1", "t2")
SESSION_ROUNDS = 3
#: the flagship session feeds the 24-chunk corpus in this many feeds
SESSION_FEEDS = 4
TOPK_K = 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(torch, fn, reps=REPS, rounds=5):
    """Milliseconds per call of *fn*, for host-synchronising code (the
    plain versions, the library call): CUDA events around *reps* calls
    back to back after warm-up, divided by *reps*; the median of
    *rounds* such rounds."""
    for _ in range(min(3, reps)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_ms(torch, fn):
    """Device milliseconds per call of a kernel wrapper *fn*: REPS calls
    captured into one CUDA graph, so the replay runs the launches back to
    back with no host work (allocation, ctypes) between them; CUDA
    events around a replay, divided by REPS.  Returns the median of 5
    replays and their spread, (max - min) / median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    del graph
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def bound(nbytes, nops, ops_per_s=INT_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the ALU rate (or *ops_per_s*)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want):
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def tile_variants(kc, source, define, tiles):
    """``{label: defines}`` of a tile A/B over *tiles*: the tile that
    *source* sets with ``#define`` *define* is its own build, ``()``;
    each other tile a variant build."""
    own = re.search(rf"#define {define} (\d+)",
                    (kc.CSRC / f"{source}.cu").read_text())
    check(own is not None, f"{source}.cu defines no {define}")
    return {f"tile={t}": (() if t == int(own.group(1)) else ((define, t),))
            for t in tiles}


def scan_variants(kc, source):
    """The tile A/B of tokenize or segreduce over SCAN_TILE_AB."""
    return tile_variants(kc, source, SCAN_TILE_DEFINES[source], SCAN_TILE_AB)


def plan_variants(kc):
    """The tile A/B of the exchange plan over PLAN_TILE_AB."""
    return tile_variants(kc, "radix", "MR_PLAN_TILE", PLAN_TILE_AB)


def tile_libraries(kc, source, signatures):
    """``{"tile=T": library}``: *source*'s build for each tile of
    SCAN_TILE_AB (phase 1's builds)."""
    return {v: kc.library(source, signatures, d)
            for v, d in scan_variants(kc, source).items()}


def timed_turns(torch, libs, label, call, same):
    """Each build of *libs* called through ``call(lib)``, its outputs
    checked by *same*, then timed in turns (A B C C B A): ``{name: [ms,
    ms]}``.  These launches are the A/B's, not the path's: uncounted."""
    names = list(libs)
    out = {v: [] for v in names}
    for v in names + names[::-1]:
        res = call(libs[v])
        torch.cuda.synchronize()
        check(same(res), f"{label}: the {v} build differs")
        out[v].append(kernel_ms(torch, lambda: call(libs[v]))[0])
    return out


def tokenize_call(torch, kc, tok, lib, chunk, mults):
    """One C call of ``mr_tokenize`` through *lib* (a tile variant's
    build), as ``tok._tokenize_cuda`` makes it, uncounted."""
    dev = chunk.device
    n, nl = chunk.numel(), len(mults)
    keys = torch.empty((n, nl), dtype=torch.int32, device=dev)
    is_end = torch.empty(n, dtype=torch.bool, device=dev)
    start = torch.empty(n, dtype=torch.int32, device=dev)
    length = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mr_tokenize_scratch_bytes(n, nl),
                          dtype=torch.uint8, device=dev)
    a = [int(x) & kc.MASK32 for x in mults] + [0] * (3 - nl)
    kc.check("tokenize", lib.mr_tokenize(
        kc.ptr(chunk), n, nl, a[0], a[1], a[2], kc.ptr(keys),
        kc.ptr(is_end), kc.ptr(start), kc.ptr(length), kc.ptr(scratch),
        kc.stream(dev)))
    return tok.TokenStream(is_end, keys, start, length)


def tokenize_phase(torch, kc, tok, chunk):
    """Phase 2: returns the kernel's record for the JSON line."""
    mults = (tok.HASH_A1, tok.HASH_A2)
    got = tok._tokenize_cuda(chunk, mults)
    want = tok._tokenize_plain(chunk, mults)
    torch.cuda.synchronize()
    err = 0
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        check(torch.equal(a, b), f"tokenize kernel differs in {f}")
        err = max(err, max_abs_err(torch, a, b))
    n, nl = chunk.numel(), len(mults)
    ms, spread = kernel_ms(torch, lambda: tok._tokenize_cuda(chunk, mults))
    plain_ms = time_ms(torch, lambda: tok._tokenize_plain(chunk, mults))
    # bytes: 1 in; keys 4*lanes + is_end 1 + start 4 + length 4 out.
    # ops: ~12 classify/flag ops per byte plus 3 per byte and lane
    b_ms, b_by = bound(n * (1 + 4 * nl + 9), n * (12 + 3 * nl))
    libs = tile_libraries(kc, "tokenize", tok._SIGNATURES)
    def call(lib):
        return tokenize_call(torch, kc, tok, lib, chunk, mults)

    ab = timed_turns(torch, libs, "tokenize", call,
                     lambda out: all(torch.equal(getattr(out, f),
                                                 getattr(want, f))
                                     for f in want._fields))
    replay_check(torch, "tokenize_replay",
                 lambda: tok._tokenize_cuda(chunk, mults), n)
    print(f"tokenize n={n} lanes={nl}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(json.dumps({"tokenize_case": {
        "n": n, "lanes": nl, "ms": ms, "spread": spread, "bound_ms": b_ms,
        "tile_ab_ms": ab}}))
    return {"name": "tokenize", "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/tokenize.cu",
            "replaces": "mapreduce_tpu/ops/tokenize.py:197",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def segreduce_call(torch, kc, seg, lib, k1s, k2s, vals, op, unit):
    """One C call of ``mr_segreduce`` through *lib* (a tile variant's
    build), as ``seg._segment_reduce_cuda`` makes it, uncounted."""
    dev, n = k1s.device, k1s.numel()
    if unit:
        d, codes, v = 1, [0, 0, 0], None
    else:
        d = len(vals)
        codes = ([seg._OP_CODES[o] for o in seg._lane_ops(op, d)]
                 + [0] * (3 - d))
        v = torch.stack(list(vals), dim=-1).contiguous()
    reduced = torch.empty((n, d), dtype=torch.int32, device=dev)
    end_csum = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mr_segreduce_scratch_bytes(n, d),
                          dtype=torch.uint8, device=dev)
    kc.check("segreduce", lib.mr_segreduce(
        kc.ptr(k1s), kc.ptr(k2s), kc.ptr(v) if v is not None else None, n,
        d, int(unit), *codes, kc.ptr(reduced), kc.ptr(end_csum),
        kc.ptr(scratch), kc.stream(dev)))
    return [reduced[:, i] for i in range(d)], end_csum


def segreduce_case(torch, kc, seg, libs, label, k1s, k2s, vals, op, unit):
    """One segreduce shape: equality on the surface (reduced lanes at run
    ends, end_csum everywhere), timings, the tile A/B and the replay
    check."""
    got = seg._segment_reduce_cuda(k1s, k2s, vals, op, unit)
    want = seg._segment_reduce_plain(k1s, k2s, vals, op, unit)
    torch.cuda.synchronize()
    _, _, is_end = seg._run_flags(k1s, k2s)

    def same(out):
        return torch.equal(out[1], want[1]) and all(
            torch.equal(g[is_end], w[is_end]) for g, w in zip(out[0], want[0]))

    check(torch.equal(got[1], want[1]), f"segreduce {label}: end_csum")
    err = max_abs_err(torch, got[1], want[1])
    for g, w in zip(got[0], want[0]):
        check(torch.equal(g[is_end], w[is_end]),
              f"segreduce {label}: reduced lanes at run ends")
        err = max(err, max_abs_err(torch, g[is_end], w[is_end]))
    n, d = k1s.numel(), (1 if unit else len(vals))
    ms, spread = kernel_ms(torch, lambda: seg._segment_reduce_cuda(
        k1s, k2s, vals, op, unit))
    plain_ms = time_ms(torch, lambda: seg._segment_reduce_plain(
        k1s, k2s, vals, op, unit))
    # bytes: keys 8 + values 4*d in (none in unit mode); reduced 4*d +
    # end_csum 4 out.  ops: ~10 compare/flag ops per row plus 2 per lane
    in_lanes = 0 if unit else d
    b_ms, b_by = bound(n * (8 + 4 * in_lanes + 4 * d + 4), n * (10 + 2 * d))
    ab = timed_turns(torch, libs, f"segreduce {label}",
                     lambda lib: segreduce_call(torch, kc, seg, lib, k1s, k2s,
                                                vals, op, unit), same)
    replay_check(torch, f"segreduce_replay {label}",
                 lambda: seg._segment_reduce_cuda(k1s, k2s, vals, op, unit),
                 n)
    print(f"segreduce {label} n={n}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    case = {"label": label, "n": n, "max_abs_err": err, "ms": ms,
            "spread": spread, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile_ab_ms": ab}
    if not unit:  # the wrapper's packing of the value lanes, part of ms
        case["pack_ms"] = kernel_ms(torch, lambda: torch.stack(
            list(vals), dim=-1).contiguous())[0]
    return case


def segreduce_phase(torch, kc, seg, wcmod, chunks_dev, cfg):
    """Phase 3 at the main path's shapes, on inputs the path itself
    makes from the corpus: the combiner's input (one chunk's records),
    the local reduce's (12 combined chunks), the fold's (accumulator +
    one exchange block), and the verify monoid's (3 value lanes)."""
    from dataclasses import replace

    def sorted_lanes(keys, valid, vals):
        k1 = torch.where(valid, keys[:, 0], seg.SENTINEL)
        k2 = torch.where(valid, keys[:, 1], seg.SENTINEL)
        perm = seg._sort_perm(k1, k2, "variadic")
        return (k1[perm].contiguous(), k2[perm].contiguous(),
                [v[perm].contiguous() for v in vals])

    libs = tile_libraries(kc, "segreduce", seg._SIGNATURES)
    ucfg = replace(cfg, unit_values=True, reduce_op="sum")
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn(chunks_dev[0], 0,
                                                        ucfg)
    k1s, k2s, _ = sorted_lanes(keys, valid, [])
    cases = [segreduce_case(torch, kc, seg, libs, "combiner/unit", k1s, k2s,
                            [], "sum", True)]
    # library yardstick of the unit case: runs and their lengths of the
    # sorted packed key
    packed = ((k1s.to(torch.int64) & 0xFFFFFFFF) << 32) | (
        k2s.to(torch.int64) & 0xFFFFFFFF)
    cases[0]["library_ms"] = time_ms(
        torch, lambda: torch.unique_consecutive(packed, return_counts=True))

    Tc = cfg.scan_combine_slots(keys.shape[0])
    bk, bv, bvalid = [], [], []
    for j in range(12):
        kj, vj, pj, mj, _ = wcmod._wordcount_map_fn(chunks_dev[j], j, ucfg)
        cu = seg.sorted_unique_reduce(kj, vj, pj, mj, Tc, "sum",
                                      unit_values=True)
        bk.append(cu.keys)
        bv.append(cu.values)
        bvalid.append(cu.valid)
    buf_k, buf_v, buf_valid = torch.cat(bk), torch.cat(bv), torch.cat(bvalid)
    k1s, k2s, vs = sorted_lanes(buf_k, buf_valid, [buf_v])
    cases.append(segreduce_case(torch, kc, seg, libs, "local/sum", k1s, k2s,
                                vs, "sum", False))

    local = seg.sorted_unique_reduce(
        buf_k, buf_v, torch.zeros((buf_k.shape[0], 1), dtype=torch.int32,
                                  device=buf_k.device),
        buf_valid, cfg.out_capacity, "sum")
    ex = cfg.exchange_capacity
    fk = torch.cat([local.keys, local.keys[:ex]])
    fv = torch.cat([local.values, local.values[:ex]])
    fvalid = torch.cat([local.valid, local.valid[:ex]])
    k1s, k2s, vs = sorted_lanes(fk, fvalid, [fv])
    cases.append(segreduce_case(torch, kc, seg, libs, "fold/sum", k1s, k2s,
                                vs, "sum", False))

    vcfg = replace(cfg, unit_values=False, reduce_op=wcmod.VERIFY_REDUCE_OP)
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn_verify(
        chunks_dev[0], 0, vcfg)
    k1s, k2s, vs = sorted_lanes(keys, valid,
                                [vals[:, i] for i in range(3)])
    cases.append(segreduce_case(torch, kc, seg, libs, "verify/(sum,min,max)",
                                k1s, k2s, vs, wcmod.VERIFY_REDUCE_OP, False))
    for c in cases:
        print(json.dumps({"segreduce_case": c}))
    head = cases[0]
    return {"name": "segreduce", "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/segreduce.cu",
            "replaces": "mapreduce_tpu/ops/segscan.py:193",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]}


def _profile_group(name):
    if "mr_tokenize_kernels" in name:
        return "tokenize kernel"
    if "mr_segreduce_kernels" in name:
        return "segreduce kernel"
    if "mr_radix_kernels" in name:
        if "onesweep_kernel" in name:
            return "radix onesweep"
        if "upfront_kernel" in name:
            return "radix upfront"
        return "radix plan"
    low = name.lower()
    if "memset" in low:
        return "memset"
    if "sort" in low and "searchsorted" not in low:
        return "torch.sort"
    if "memcpy htod" in low:
        return "upload (memcpy HtoD)"
    return "other"


def trace_events(prof):
    """The device events (kernels, copies, memsets) of a finished
    profile, from its Chrome trace: ``[{"cat", "name", "stream", "ts",
    "dur"}]`` in microseconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [{"cat": e["cat"], "name": e["name"],
             "stream": (e.get("args") or {}).get("stream", e.get("tid")),
             "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
            for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _covered(intervals, lo, hi):
    """Microseconds of [lo, hi) inside the union of sorted *intervals*."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in intervals)


def upload_report(label, events, expect=None):
    """Phase 5's check of a run's uploads: every host-to-device copy
    pinned and on another stream than the port's kernels; prints the
    copies' device ms, the share of it that overlaps kernel time, and
    beside the copies traced the *expect* ones issued (a wave each)."""
    h2d = [e for e in events
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    ours = [e for e in events if e["cat"] == "kernel"
            and _profile_group(e["name"]) != "other"]
    check(h2d and ours, f"{label}: {len(h2d)} uploads and {len(ours)} "
          "kernels of the port in the trace; both must be there")
    pageable = sorted({e["name"] for e in h2d if "Pinned" not in e["name"]})
    check(not pageable, f"{label}: pageable host-to-device copies: "
          f"{pageable}")
    kernel_streams = {e["stream"] for e in ours}
    copy_streams = {e["stream"] for e in h2d}
    check(not kernel_streams & copy_streams,
          f"{label}: uploads on the kernels' stream {kernel_streams}")
    # the union of every kernel's interval on the kernels' streams
    busy = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e["cat"] == "kernel"
                       and e["stream"] in kernel_streams):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    h2d_us = sum(e["dur"] for e in h2d)
    overlap_us = sum(_covered(busy, e["ts"], e["ts"] + e["dur"])
                     for e in h2d)
    print(json.dumps({f"{label}_upload": {
        "h2d_ms": h2d_us / 1e3, "copies": len(h2d),
        "expected_copies": expect,
        "overlap_share": overlap_us / h2d_us,
        "copy_streams": sorted(copy_streams),
        "kernel_streams": sorted(kernel_streams)}}))


def device_profile(torch, label, run, group_of, on_trace=None):
    """Run *run* once under torch.profiler; prints device microseconds and
    events by ``group_of(kernel name)`` and the 12 largest device events
    under *label*, and returns both by group: ``(us, events)``.  With
    *on_trace*, calls it with the run's :func:`trace_events`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    groups, calls, rows = {}, {}, []
    for ev in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels'
        # time, which would count them twice; the profiler's own buffer
        # requests are not the program's work
        if (ev.device_type != DeviceType.CUDA
                or ev.key == "Activity Buffer Request"):
            continue
        dev_us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if dev_us <= 0:
            continue
        g = group_of(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
        calls[g] = calls.get(g, 0) + ev.count
        rows.append((dev_us, ev.count, ev.key[:100], g))
    rows.sort(reverse=True)
    device_us = sum(groups.values())
    print(json.dumps({label: {
        "wall_us": wall_us, "device_us_total": device_us,
        "busy_share": device_us / wall_us, "device_us": groups,
        "device_calls": calls,
        "top": [{"device_us": r[0], "calls": r[1], "name": r[2],
                 "group": r[3]} for r in rows[:12]]}}))
    if on_trace is not None:
        on_trace(trace_events(prof))
    return groups, calls


def profile_phase(torch, kc, wc, chunks, label="profile", waves=None,
                  need=("tokenize kernel", "segreduce kernel"), forbid=()):
    """One engine run of a slice under torch.profiler (printed).  Fails if
    a group in *need* shows no device time or one in *forbid* shows any,
    if the tokenize, segreduce or plan kernel events differ in number
    from their wrappers' launches in the run (one kernel a call), or if
    an upload is pageable or on the kernels' stream (:func:`
    upload_report`)."""
    engine = wc._engine_for(chunks.shape[1])
    kc.reset_counts()
    tm = {}
    groups, calls = device_profile(
        torch, label, lambda: engine.run(chunks, waves=waves, timings=tm),
        _profile_group,
        on_trace=lambda ev: upload_report(label, ev, expect=tm["waves"]))
    check(all(groups.get(g, 0) > 0 for g in need),
          f"{label}: profiled run shows no device time in {need}: {groups}")
    check(all(groups.get(g, 0) == 0 for g in forbid),
          f"{label}: profiled run shows device time in {forbid}: {groups}")
    for k, group in (("tokenize", "tokenize kernel"),
                     ("segreduce", "segreduce kernel"),
                     ("radix_plan", "radix plan")):
        check(calls.get(group, 0) == kc.LAUNCHES[k],
              f"{label}: {calls.get(group, 0)} {group} events for "
              f"{kc.LAUNCHES[k]} wrapper launches")


def radix_inputs(torch, seg, wcmod, chunks_dev, cfg):
    """Inputs the radix path makes from the corpus (phase 6): the key
    lanes of a combiner sort (one chunk's records, invalid rows as the
    sentinel pair), of a local sort (two combined chunks), of a fold sort
    (a local result followed by eight combined chunks: the accumulator
    and the eight exchange blocks), and the plan's destinations ``[8,
    local_capacity]`` (``k1 % 8`` of eight local results, 8 where
    invalid)."""
    from dataclasses import replace

    ucfg = replace(cfg, unit_values=True, reduce_op="sum")

    def lanes(keys, valid):
        return (torch.where(valid, keys[:, 0], seg.SENTINEL).contiguous(),
                torch.where(valid, keys[:, 1], seg.SENTINEL).contiguous())

    keys, _, _, valid, _ = wcmod._wordcount_map_fn(chunks_dev[0], 0, ucfg)
    Tc = cfg.scan_combine_slots(keys.shape[0])
    combiner = lanes(keys, valid)
    combined = []
    for j in range(2 * RADIX_PARTS):
        kj, vj, pj, mj, _ = wcmod._wordcount_map_fn(chunks_dev[j], j, ucfg)
        combined.append(seg.sorted_unique_reduce(kj, vj, pj, mj, Tc, "sum",
                                                 unit_values=True))
    locals_ = []
    for p in range(RADIX_PARTS):
        a, b = combined[2 * p], combined[2 * p + 1]
        lk = torch.cat([a.keys, b.keys])
        locals_.append(seg.sorted_unique_reduce(
            lk, torch.cat([a.values, b.values]),
            torch.zeros((lk.shape[0], 1), dtype=torch.int32,
                        device=lk.device),
            torch.cat([a.valid, b.valid]), cfg.local_capacity, "sum"))
    local = lanes(torch.cat([combined[0].keys, combined[1].keys]),
                  torch.cat([combined[0].valid, combined[1].valid]))
    fold_parts = [locals_[0]] + combined[2:2 + RADIX_PARTS]
    fold = lanes(torch.cat([u.keys for u in fold_parts]),
                 torch.cat([u.valid for u in fold_parts]))
    dest = torch.stack([
        torch.where(u.valid, (u.keys[:, 0].to(torch.int64) & 0xFFFFFFFF)
                    % RADIX_PARTS, RADIX_PARTS).to(torch.int32)
        for u in locals_]).contiguous()
    return {"combiner": combiner, "local": local, "fold": fold}, dest


def radix_pass_case(torch, rs, label, k1, k2):
    """The upfront kernel and one onesweep pass (the digit of a second
    pass, with a permutation lane) against the plain versions, and their
    times."""
    n = k1.numel()
    perm = torch.randperm(n, device=k1.device).to(torch.int32)
    got_t = rs._radix_upfront_cuda(k1, k2)
    want_t = rs._radix_upfront_plain(k1, k2)
    check(torch.equal(got_t, want_t), f"radix_upfront {label} differs")
    err = max_abs_err(torch, got_t, want_t)
    lane, shift = 1, 8
    counts = want_t[rs.PASSES.index((lane, shift))].contiguous()
    got = tuple(torch.empty(n, dtype=torch.int32, device=k1.device)
                for _ in range(3))
    want = tuple(torch.empty_like(g) for g in got)
    rs._radix_onesweep_cuda(k1, k2, perm, lane, shift, counts, got)
    rs._radix_onesweep_plain(k1, k2, perm, lane, shift, counts, want)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"radix_onesweep {label} differs")
        err = max(err, max_abs_err(torch, g, w))
    u_ms, u_spread = kernel_ms(torch, lambda: rs._radix_upfront_cuda(k1, k2))
    u_plain = time_ms(torch, lambda: rs._radix_upfront_plain(k1, k2),
                      reps=5, rounds=3)
    # library yardstick: one bincount over pass * R + digit (the index
    # made beforehand; the port never calls bincount on the card)
    idx = torch.cat([p * rs.RADIX + rs._pass_digits(k1, k2, ln, sh)
                     for p, (ln, sh) in enumerate(rs.PASSES)])
    u_lib = time_ms(torch, lambda: torch.bincount(
        idx, minlength=rs.RADIX_PASSES * rs.RADIX))
    o_ms, o_spread = kernel_ms(torch, lambda: rs._radix_onesweep_cuda(
        k1, k2, perm, lane, shift, counts, got))
    o_plain = time_ms(torch, lambda: rs._radix_onesweep_plain(
        k1, k2, perm, lane, shift, counts, want), reps=2, rounds=3)
    # the same pass (the sort's second) on the sort's own inputs, pass 0's
    # outputs, instead of the input order and a random perm
    p0 = tuple(torch.empty_like(g) for g in got)
    rs._radix_onesweep_cuda(k1, k2, None, *rs.PASSES[0], want_t[0], p0)
    rs._radix_onesweep_plain(*p0, lane, shift, counts, want)
    rs._radix_onesweep_cuda(*p0, lane, shift, counts, got)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"radix_onesweep {label} differs on pass 0's outputs")
    o_sort_ms, _ = kernel_ms(torch, lambda: rs._radix_onesweep_cuda(
        *p0, lane, shift, counts, got))
    # bytes, each input read once and each output written once: upfront
    # reads (k1, k2) and writes the [8, 256] table; a pass reads (k1, k2,
    # perm) and the 256 counts and writes (k1, k2, perm).  ops: 8 digits
    # and 8 counts a row up front; ~12 a row in a pass
    table_bytes = 4 * rs.RADIX_PASSES * rs.RADIX
    ub_ms, ub_by = bound(8 * n + table_bytes, 16 * n)
    ob_ms, ob_by = bound(24 * n + 4 * rs.RADIX, 12 * n)
    case = {"label": label, "n": n, "max_abs_err": err,
            "tiles": -(-n // rs.RADIX_SORT_TILE),
            "upfront": {"ms": u_ms, "spread": u_spread, "plain_ms": u_plain,
                        "library_ms": u_lib, "bound_ms": ub_ms,
                        "bound_by": ub_by},
            "onesweep": {"ms": o_ms, "spread": o_spread, "plain_ms": o_plain,
                         "library_ms": None, "bound_ms": ob_ms,
                         "bound_by": ob_by,
                         "ms_on_pass0_outputs": o_sort_ms}}
    print(json.dumps({"radix_pass_case": case}))
    return case


def sort_variants(rs):
    """``{label: defines}`` of the sort's tile A/B: the build's own tile is
    the default library, ``()``; each other tile a variant build."""
    return {f"tile={t}": (() if t == rs.RADIX_SORT_TILE
                          else (("MR_ONESWEEP_TILE", t),))
            for t in SORT_TILE_AB}


def variant_sort(torch, kc, rs, defines, k1, k2):
    """The whole sort through the radix library built with *defines*: the
    C call of ``rs._radix_sort_cuda``, uncounted (an A/B launch is not
    the path's)."""
    lib = kc.library("radix", rs._SIGNATURES, defines)
    n = k1.numel()
    a = torch.empty((3, n), dtype=torch.int32, device=k1.device)
    b = torch.empty((3, n), dtype=torch.int32, device=k1.device)
    scratch = torch.empty(lib.mr_radix_sort_scratch_words(n),
                          dtype=torch.int32, device=k1.device)
    kc.check("radix_sort_pairs", lib.mr_radix_sort_pairs(
        kc.ptr(k1), kc.ptr(k2), n, *(kc.ptr(t) for t in a),
        *(kc.ptr(t) for t in b), kc.ptr(scratch), kc.stream(k1.device)))
    return b[0], b[1], b[2]


def sort_ab(torch, kc, rs, label, k1, k2, want):
    """Each tile's whole sort, checked bit-equal to *want*, then timed in
    turns (A B C C B A): ``{label: [ms, ms]}``."""
    variants = sort_variants(rs)
    names = list(variants)
    ab = {v: [] for v in names}
    for v in names + names[::-1]:
        d = variants[v]
        res = variant_sort(torch, kc, rs, d, k1, k2)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(res, want)),
              f"radix sort {label}: the {v} build differs")
        ab[v].append(kernel_ms(torch, lambda: variant_sort(
            torch, kc, rs, d, k1, k2))[0])
    return ab


def radix_sort_case(torch, kc, rs, label, k1, k2):
    """The whole sort against the plain passes and torch.sort, its time
    beside both bounds, and the A/B of the sort's tile size."""
    n = k1.numel()
    got = rs.radix_sort_pairs(k1, k2)
    want = rs._radix_sort_plain(k1, k2)
    packed = ((k1.to(torch.int64) & 0xFFFFFFFF) - 2 ** 31) * 2 ** 32 + (
        k2.to(torch.int64) & 0xFFFFFFFF)
    order = torch.sort(packed, stable=True).indices
    torch.cuda.synchronize()
    for g, w, lane in zip(got, want, ("k1", "k2", "perm")):
        check(torch.equal(g, w), f"radix sort {label}: {lane} differs "
              "from the plain passes")
    check(torch.equal(got[2].to(torch.int64), order),
          f"radix sort {label}: perm differs from torch.sort's")
    ms, spread = kernel_ms(torch, lambda: rs.radix_sort_pairs(k1, k2))
    plain_ms = time_ms(torch, lambda: rs._radix_sort_plain(k1, k2),
                       reps=1, rounds=3)
    lib_ms = time_ms(torch, lambda: torch.sort(packed, stable=True))
    # the sort as a function: reads (k1, k2), writes (k1s, k2s, perm)
    b_ms, b_by = bound(20 * n, 0)
    # the onesweep traffic: 8 B a row up front, 20 B in pass 0 (perm is
    # the row index), 24 B in each of passes 1-7
    t_ms, t_by = bound((8 + 20 + 24 * (rs.RADIX_PASSES - 1)) * n, 0)
    ab = sort_ab(torch, kc, rs, label, k1, k2, got)
    case = {"label": label, "n": n, "ms": ms, "spread": spread,
            "plain_ms": plain_ms, "torch_sort_ms": lib_ms,
            "vs_torch_sort": ms / lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "traffic_bound_ms": t_ms, "tile": rs.RADIX_SORT_TILE,
            "tiles": -(-n // rs.RADIX_SORT_TILE),
            "passes": rs.RADIX_PASSES,
            "tile_ab_ms": ab}
    print(json.dumps({"radix_sort_case": case}))
    return case


def replay_check(torch, label, fn, n):
    """*fn* (a kernel wrapper call) captured once in a CUDA graph and
    replayed REPLAYS times: every replay's outputs (a tensor or nested
    tuples and lists of them) bit-equal to the first.  A look-back race,
    or a flag or tile counter not zeroed inside the replay, shows here."""
    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flat(fn())
    graph.replay()
    first = [t.clone() for t in out]
    for i in range(REPLAYS):
        graph.replay()
        check(all(torch.equal(a, b) for a, b in zip(out, first)),
              f"{label} replay {i + 1} differs from the first")
    del graph
    print(json.dumps({label: {"n": n, "replays": REPLAYS,
                              "bit_equal": True}}))


def radix_replay_check(torch, rs, k1, k2):
    """The sort captured once in a CUDA graph and replayed REPLAYS
    times: every replay's outputs bit-equal to the first (the look-back
    flags and tile counters are zeroed inside each replay)."""
    replay_check(torch, "radix_replay", lambda: rs.radix_sort_pairs(k1, k2),
                 k1.numel())


def plan_call(torch, kc, lib, dest, nb):
    """One C call of ``mr_radix_plan`` through *lib* (a tile variant's
    build), as ``rs._radix_plan_cuda`` makes it, uncounted."""
    b, n = dest.shape
    scratch = torch.empty(lib.mr_radix_plan_scratch_words(n, b, nb),
                          dtype=torch.int32, device=dest.device)
    rank = torch.empty_like(dest)
    totals = torch.empty((b, nb), dtype=torch.int32, device=dest.device)
    kc.check("radix_plan", lib.mr_radix_plan(
        kc.ptr(dest), n, b, nb, kc.ptr(scratch), kc.ptr(rank),
        kc.ptr(totals), kc.stream(dest.device)))
    return rank, totals


def radix_plan_case(torch, kc, rs, dest):
    """The plan over [8, 262,144] with 9 buckets, one C call: rank and
    totals against the plain version, its time beside the memory bound,
    the plain version's and torch.bincount's (the counts alone), 50
    graph replays bit-equal, and the A/B of the plan's tile size."""
    b, n = dest.shape
    nb = RADIX_PARTS + 1
    got = rs._radix_plan_cuda(dest, nb)
    want = rs._radix_plan_plain(dest, nb)
    torch.cuda.synchronize()
    err = 0
    for g, w, what in zip(got, want, ("rank", "totals")):
        check(torch.equal(g, w), f"radix_plan: {what} differs from the "
              "plain version")
        err = max(err, max_abs_err(torch, g, w))
    ms, spread = kernel_ms(torch, lambda: rs._radix_plan_cuda(dest, nb))
    plain_ms = time_ms(torch, lambda: rs._radix_plan_plain(dest, nb),
                       reps=5, rounds=3)
    # library yardstick: the counts alone, one bincount over row * nb +
    # bucket (the index made beforehand)
    idx = (torch.arange(b, device=dest.device)[:, None] * nb
           + dest.to(torch.int64)).reshape(-1)
    lib_ms = time_ms(torch, lambda: torch.bincount(idx, minlength=b * nb))
    # reads dest and writes rank, 4 B a row each, and writes the totals
    b_ms, b_by = bound(8 * b * n + 4 * b * nb, 12 * b * n)
    replay_check(torch, "radix_plan_replay",
                 lambda: rs.radix_partition_plan(dest, RADIX_PARTS), b * n)
    libs = {v: kc.library("radix", rs._SIGNATURES, d)
            for v, d in plan_variants(kc).items()}
    ab = timed_turns(torch, libs, "radix plan",
                     lambda lib: plan_call(torch, kc, lib, dest, nb),
                     lambda res: all(torch.equal(g, w)
                                     for g, w in zip(res, want)))
    case = {"label": "plan", "shape": [b, n], "buckets": nb,
            "max_abs_err": err, "ms": ms, "spread": spread,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile": rs.RADIX_TILE,
            "ctas": b * -(-n // rs.RADIX_TILE), "tile_ab_ms": ab}
    print(json.dumps({"radix_plan_case": case}))
    return case


def radix_phase(torch, kc, rs, inputs, dest):
    """Phase 6: returns the three radix kernels' records."""
    sorts = [radix_sort_case(torch, kc, rs, label, *inputs[label])
             for label in ("combiner", "local", "fold")]
    radix_replay_check(torch, rs, *inputs["fold"])
    passes = [radix_pass_case(torch, rs, label, *inputs[label])
              for label in ("combiner", "fold")]
    plan = radix_plan_case(torch, kc, rs, dest)
    err = max(c["max_abs_err"] for c in passes)
    head = passes[0]  # the combiner shape: 32 of the 64 sorts per run

    def record(name, lines, t, error):
        return {"name": name, "route": "cuda",
                "source": "mapreduce_tpu_torch/csrc/radix.cu",
                "replaces": ", ".join(f"mapreduce_tpu/ops/radix_sort.py:{ln}"
                                      for ln in lines),
                "max_abs_err": error, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # the plan replaces the plan's use of _hist_kernel and _rank_kernel
    return ([record("radix_plan", (96, 112), plan, plan["max_abs_err"]),
             record("radix_upfront", (96,), head["upfront"], err),
             record("radix_onesweep", (119,), head["onesweep"], err)],
            {"sorts": sorts, "passes": passes, "plan": plan})


def radix_slice_phase(torch, kc, rs, wcmod, Partitions, data, want):
    """Phase 7: the radix slice over 8 partitions; returns the word count
    and the launch counts of its counted run."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
    wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                               chunk_len=CHUNK_LEN, config=cfg)
    wc.count_bytes(data, waves=RADIX_WAVES)  # warm
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    check(got == want, "radix slice: counts differ from Counter")
    check(tm["waves"] == RADIX_WAVES, f"radix slice: {tm['waves']} waves")
    check(all(launches[k] > 0 for k in WORDCOUNT_KERNELS),
          f"radix slice: a kernel was never launched: {launches}")
    check(launches["radix_onesweep"]
          == rs.RADIX_PASSES * launches["radix_upfront"],
          f"radix slice: a sort is not one upfront and "
          f"{rs.RADIX_PASSES} onesweep launches: {launches}")
    check(all(v == 0 for v in plain.values()),
          f"radix slice: plain versions ran on the card path: {plain}")
    matrix = tm["exchange"]["matrix"]
    t0 = time.monotonic()
    host = wc.host_exchange_matrix(data, waves=RADIX_WAVES)
    host_s = time.monotonic() - t0
    check(host.tolist() == matrix, "radix slice: traffic matrix differs "
          "from host_exchange_matrix")
    n_words = sum(want.values())
    print(json.dumps({"slice_radix": {
        "partitions": RADIX_PARTS, "words": n_words, "unique": len(want),
        "waves": tm["waves"], "retries": tm["retries"],
        "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
        "readback_s": tm["readback_s"], "materialize_s": tm["materialize_s"],
        "wall_s": wall, "words_per_s_compute": n_words / tm["compute_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "matrix": matrix, "host_matrix_s": host_s,
        "launches": launches, "plain_calls": plain}}))
    return wc, launches, matrix


def partition_map_phase(torch, wcmod, Partitions, tok, plan_rebalance,
                        wc, data, want):
    """Phase 7, last part: the radix slice under a plan_rebalance table
    made from the corpus's bucket weights."""
    from dataclasses import replace

    chunks, L = wc._to_chunks(data)
    cfg = replace(wc.config, partition_map=True)
    B = wcmod.partition_buckets_for(cfg, RADIX_PARTS)
    hashes = tok.word_hashes_host(b" ".join(want))
    weights = [0] * B
    for word, c in want.items():
        weights[hashes[word][0] % B] += c
    table = plan_rebalance(weights, RADIX_PARTS)
    pwc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                                chunk_len=CHUNK_LEN, config=wc.config,
                                partition_map=table)
    tm = {}
    check(pwc.count_bytes(data, timings=tm, waves=RADIX_WAVES) == want,
          "partition map: counts differ from Counter")
    matrix = tm["exchange"]["matrix"]
    check(pwc.host_exchange_matrix(data, waves=RADIX_WAVES).tolist()
          == matrix, "partition map: traffic matrix differs from the "
          "host recompute under the table")
    print(json.dumps({"partition_map": {
        "buckets": B, "table": table.tolist(),
        "col_sums": tm["exchange"]["col_sums"],
        "compute_s": tm["compute_s"]}}))


def staged_phase(torch, kc, wc, data, want):
    """Phase 4's staged run in the flagship bench's order: ``stage``
    (ingress, residency included), ``warm``, then ``count_staged``: the
    counts, no upload charged, no plain call, and the staged bytes freed
    once the handle is consumed."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    handle = wc.stage(data)
    ingress_s = time.monotonic() - t0
    staged_bytes = sum(t.numel() * t.element_size() for t in handle[2][0])
    mem_staged = torch.cuda.memory_allocated()
    warm_s = wc.warm()
    kc.reset_counts()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_staged(handle, timings=tm)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    del handle
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    check(got == want, "staged: counts differ from Counter")
    check("upload_s" not in tm, f"staged: upload charged: {tm}")
    check(all(v == 0 for v in plain.values()),
          f"staged: plain versions ran on the card path: {plain}")
    check(launches["tokenize"] > 0 and launches["segreduce"] > 0,
          f"staged: kernels not launched: {launches}")
    check(mem_staged - mem_after >= staged_bytes,
          f"staged: memory fell {mem_staged - mem_after} bytes, the "
          f"handle held {staged_bytes}")
    print(json.dumps({"staged": {
        "ingress_s": ingress_s, "warm_s": warm_s,
        "compute_s": tm["compute_s"], "readback_s": tm["readback_s"],
        "materialize_s": tm["materialize_s"], "wall_s": wall,
        "first_dispatch_s": tm["first_dispatch_s"], "waves": tm["waves"],
        "staged_bytes": staged_bytes, "memory_allocated_staged": mem_staged,
        "memory_allocated_after": mem_after,
        "launches": launches}}))


def count_sorts(torch):
    """Wrap ``torch.sort`` with a call counter (``tiered_phase``);
    returns ``(counter list, restore)``."""
    orig = torch.sort
    n = [0]

    def counted(*args, **kwargs):
        n[0] += 1
        return orig(*args, **kwargs)

    torch.sort = counted

    def restore():
        torch.sort = orig
    return n, restore


def tiered_phase(torch, kc, wcmod, tiering, Partitions, data, want,
                 matrix):
    """Phase 7b: ``sort_impl='tiered-radix'`` over 8 partitions, (a) warm,
    (b) forced cold, (c) truly cold in a subprocess; *matrix* is the
    radix slice's traffic matrix (already held against the host)."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="tiered-radix")
    wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                               chunk_len=CHUNK_LEN, config=cfg)
    out = {}
    # (a) warm: every library built, tier 1 (radix) from the first wave
    kc.reset_counts()
    tm = {}
    got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    launches = dict(kc.LAUNCHES)
    check(got == want, "tiered warm: counts differ from Counter")
    check(tm["exchange"]["matrix"] == matrix,
          "tiered warm: traffic matrix differs")
    check((tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"])
          == ("radix", False, 0), f"tiered warm: {tm}")
    check(all(launches[k] > 0 for k in WORDCOUNT_KERNELS),
          f"tiered warm: a kernel was never launched: {launches}")
    check(not any(kc.PLAIN_CALLS.values()), "tiered warm: plain calls")
    out["warm"] = {k: tm[k] for k in ("serving_tier", "tier_cold_start",
                                      "tier_swaps", "first_dispatch_s",
                                      "compute_s")}
    # (b) forced cold: tier 0 (torch.sort, no radix launch) serves wave 0
    engine = wc.engine
    orig_wave = engine._wave
    per_wave = []
    sorts, restore = count_sorts(torch)

    def spy(wave_cfg, *args):
        res = orig_wave(wave_cfg, *args)
        per_wave.append((wave_cfg.sort_impl, sorts[0],
                         kc.LAUNCHES["radix_upfront"]
                         + kc.LAUNCHES["radix_plan"]))
        return res

    engine._wave = spy
    kc.reset_counts()
    tm = {}
    try:
        with tiering.force_cold():
            got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    finally:
        del engine._wave
        restore()
    check(got == want, "tiered cold: counts differ from Counter")
    check(tm["exchange"]["matrix"] == matrix,
          "tiered cold: traffic matrix differs")
    check(tm["tier_cold_start"] and tm["tier_swaps"] <= 1,
          f"tiered cold: {tm}")
    check(per_wave[0][0] == "argsort" and per_wave[0][1] > 0
          and per_wave[0][2] == 0,
          f"tiered cold: wave 0 did not run on tier 0 alone: {per_wave}")
    check(tm["tier_specialize_failed"] is None,
          f"tiered cold: {tm['tier_specialize_failed']}")
    check(not any(kc.PLAIN_CALLS.values()), "tiered cold: plain calls")
    key = kc.sources_for(replace(cfg, sort_impl="radix"))
    check(engine.specializer.wait(key, timeout=120),
          "tiered cold: the specializer did not finish")
    tm2 = {}
    check(wc.count_bytes(data, timings=tm2, waves=RADIX_WAVES) == want,
          "tiered after the build: counts differ")
    check(tm2["serving_tier"] == "radix",
          f"tiered after the build: served {tm2['serving_tier']}")
    out["forced_cold"] = {
        "per_wave": per_wave, "tier_swaps": tm["tier_swaps"],
        "serving_tier": tm["serving_tier"],
        "first_dispatch_s": tm["first_dispatch_s"],
        "compute_s": tm["compute_s"],
        "next_run_serving_tier": tm2["serving_tier"]}
    # (c) truly cold: fresh build directories, one subprocess each
    for impl in ("tiered-radix", "radix"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold", impl],
            capture_output=True, text=True, timeout=COLD_TIMEOUT_S)
        check(proc.returncode == 0, f"cold {impl} run failed "
              f"({proc.returncode}):\n{proc.stdout[-4000:]}"
              f"\n{proc.stderr[-4000:]}")
        out[f"cold_{impl}"] = json.loads(proc.stdout.strip().splitlines()[-1])
    check(TIER_FAILED_KEY not in json.dumps(out)
          and not tiering.TIER_COUNTS["specialize_failed"],
          "tiered: a specialization failed")
    out["tier_counts"] = dict(tiering.TIER_COUNTS)
    print(json.dumps({"tiered": out}))


#: what a cold child prints when its tier-1 build failed
TIER_FAILED_KEY = "specialize_failed_message"
#: words of the truly cold tiered count (phase 7b (c))
COLD_WORDS = 1_000_000
COLD_CHUNK_LEN = 1 << 18
COLD_TIMEOUT_S = 300


def cold_child(impl):
    """Phase 7b (c), in a process of its own: a fresh, empty build
    directory, then a ``COLD_WORDS`` count with ``sort_impl=impl`` at P =
    8, which builds what its first wave needs; prints one JSON line."""
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import tiering
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    torch.zeros(1, device="cuda")  # the context, outside the timed run
    data = make_corpus(COLD_WORDS, COLD_WORDS * N_LINES // EUROPARL_WORDS,
                       seed=1)
    want = Counter(data.split())
    with tempfile.TemporaryDirectory() as tmp:
        kc.BUILD_DIR = Path(tmp)
        cfg = replace(wcmod.bench_engine_config(), sort_impl=impl)
        wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                                   chunk_len=COLD_CHUNK_LEN, config=cfg)
        tm = {}
        t0 = time.monotonic()
        got = wc.count_bytes(data, timings=tm, waves=3)
        wall = time.monotonic() - t0
        check(got == want, f"cold {impl}: counts differ from Counter")
        out = {"impl": impl, "words": COLD_WORDS, "wall_s": wall,
               "first_dispatch_s": tm["first_dispatch_s"],
               "compute_s": tm["compute_s"], "waves": tm["waves"],
               "build_s": dict(kc.BUILD_SECONDS)}
        if impl == "tiered-radix":
            key = kc.sources_for(replace(cfg, sort_impl="radix"))
            check(wc.engine.specializer.wait(key, timeout=COLD_TIMEOUT_S),
                  "cold: the specializer did not finish")
            failed = wc.engine.specializer.failed(key)
            if failed:
                out[TIER_FAILED_KEY] = failed
            check(not failed, f"cold: the tier-1 build failed: {failed}")
            out.update(
                serving_tier=tm["serving_tier"],
                tier_cold_start=tm["tier_cold_start"],
                tier_swaps=tm["tier_swaps"],
                build_s=dict(kc.BUILD_SECONDS),
                specializer_s=wc.engine.specializer.seconds[key])
            tm2 = {}
            check(wc.count_bytes(data, timings=tm2, waves=3) == want,
                  "cold: the second run's counts differ")
            out["next_run_serving_tier"] = tm2["serving_tier"]
            check(tm2["serving_tier"] == "radix",
                  f"cold: the second run served {tm2['serving_tier']}")
    print(json.dumps(out))
    return 0


def flash_inputs(torch, fa, B, H, Tq, Tk, D, seed):
    """(q, k, v, q^, do) bf16 on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(T):
        return torch.randn((B, H, T, D), generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    return q, k, v, fa._prescale(q, D ** -0.5), do


def flash_case(torch, fa, label, B, H, Tq, Tk, D, causal):
    """The three kernels against their plain versions on one shape (the
    backward ones fed the kernel's own lse, so each is checked alone);
    returns the inputs and each kernel's max abs error."""
    q, k, v, qh, do = flash_inputs(torch, fa, B, H, Tq, Tk, D, seed=Tq + D)
    scale = D ** -0.5
    out, lse = fa._flash_fwd_cuda(qh, k, v, causal)
    w_out, w_lse = fa.flash_fwd_plain(qh, k, v, causal)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = fa._flash_dq_cuda(qh, k, v, do, lse, delta, causal, scale)
    w_dq = fa.flash_dq_plain(qh, k, v, do, lse, delta, causal, scale)
    dk, dv = fa._flash_dkv_cuda(qh, k, v, do, lse, delta, causal)
    w_dk, w_dv = fa.flash_dkv_plain(qh, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    errs = {}
    for kern, name, got, want, tol in (
            ("flash_fwd", "out", out, w_out, FLASH_TOL),
            ("flash_fwd", "lse", lse, w_lse, dict(atol=LSE_ATOL, rtol=0)),
            ("flash_dq", "dq", dq, w_dq, FLASH_TOL),
            ("flash_dkv", "dk", dk, w_dk, FLASH_TOL),
            ("flash_dkv", "dv", dv, w_dv, FLASH_TOL)):
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), f"{label}: {name} not finite")
        check(torch.allclose(g, w, **tol), f"{label}: {name} differs from "
              f"the plain version beyond {tol}: max abs err "
              f"{float((g - w).abs().max())}")
        errs[kern] = max(errs.get(kern, 0.0), float((g - w).abs().max()))
    print(json.dumps({"flash_case": {
        "label": label, "shape": [B, H, Tq, Tk, D], "causal": causal,
        "max_abs_err": errs}}))
    return (q, k, v, qh, do, lse, delta), errs


def flash_phase(torch, fa):
    """Phase 8: returns the three flash kernels' records."""
    import torch.nn.functional as F

    B, H, T, D = TF_B, TF_CONFIG["n_heads"], TF_T, TF_CONFIG["head_dim"]
    (q, k, v, qh, do, lse, delta), errs = flash_case(
        torch, fa, "slice", B, H, T, T, D, True)
    for label, shape, causal in (("full", (2, 8, 1024, 1024, 128), False),
                                 ("ragged", (2, 8, 2000, 2000, 64), True)):
        _, e = flash_case(torch, fa, label, *shape, causal)
        for kern in e:
            errs[kern] = max(errs[kern], e[kern])
    scale = D ** -0.5
    # the work: the (query, key) pairs the causal mask keeps, 2*D FLOPs a
    # pair for each product; bytes of each input read once and each
    # output written once (one bf16 [B, H, T, D] tensor, one f32 [B, H,
    # T, 1] row)
    pairs = B * H * T * (T + 1) // 2
    tensor, row = 2 * B * H * T * D, 4 * B * H * T
    work = {  # (FLOPs, bytes)
        "flash_fwd": (2 * 2 * D * pairs, 4 * tensor + row),
        "flash_dq": (3 * 2 * D * pairs, 5 * tensor + 2 * row),
        "flash_dkv": (4 * 2 * D * pairs, 6 * tensor + 2 * row)}
    calls = {
        "flash_fwd": (lambda: fa._flash_fwd_cuda(qh, k, v, True),
                      lambda: fa.flash_fwd_plain(qh, k, v, True)),
        "flash_dq": (lambda: fa._flash_dq_cuda(qh, k, v, do, lse, delta,
                                               True, scale),
                     lambda: fa.flash_dq_plain(qh, k, v, do, lse, delta,
                                               True, scale)),
        "flash_dkv": (lambda: fa._flash_dkv_cuda(qh, k, v, do, lse, delta,
                                                 True),
                      lambda: fa.flash_dkv_plain(qh, k, v, do, lse, delta,
                                                 True))}
    # the library yardstick: SDPA on the unscaled q (it scales itself)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    lib_fwd_bwd = time_ms(torch, sdpa_fwd_bwd)
    # SDPA's backward alone: one forward kept, the gradient call timed (one
    # call computes dq, dk and dv together: the yardstick of both
    # backward kernels).  Events around the calls read host time on a
    # slow host (the call's host work can exceed its device time), so the
    # yardstick is its device time under the profiler, like kernel_ms
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)

    lib_bwd = time_ms(torch, sdpa_bwd)
    groups, _ = device_profile(torch, "profile_sdpa_bwd",
                               lambda: [sdpa_bwd() for _ in range(REPS)],
                               lambda name: "sdpa backward")
    lib_bwd_device = groups["sdpa backward"] / REPS / 1e3
    del o
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd_device,
               "flash_dkv": lib_bwd_device}
    records = []
    for name, line in (("flash_fwd", 94), ("flash_dq", 153),
                       ("flash_dkv", 204)):
        kern, plain = calls[name]
        ms, spread = kernel_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=2, rounds=3)
        flops, nbytes = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        print(f"{name} [{B}, {H}, {T}, {D}] causal, tiles "
              f"{fa.TILES[name]}: kernel {ms:.4f} ms (spread {spread:.3f}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / library[name]:.2f}x "
              f"the SDPA yardstick {library[name]:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        records.append({
            "name": name, "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"mapreduce_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library[name]})
    print(json.dumps({"flash_library": {
        "sdpa_fwd_ms": lib_fwd, "sdpa_fwd_bwd_ms": lib_fwd_bwd,
        "sdpa_bwd_ms": lib_bwd, "sdpa_bwd_device_ms": lib_bwd_device,
        "kernels_fwd_ms": records[0]["ms"],
        "kernels_bwd_ms": records[1]["ms"] + records[2]["ms"]}}))
    return records


def flash_scaling(torch, fa):
    """What bounds the wgmma kernels: each timed at the slice's shape
    without the causal mask (every CTA does the same work, so no tail of
    uneven tiles) and causal with 4x the batch (4x the CTAs over the same
    SMs, so the last wave is a smaller share).  Prints one JSON line of ms
    and TFLOP/s."""
    D = TF_CONFIG["head_dim"]
    scale = D ** -0.5
    out = {}
    for label, B, causal in (("causal", TF_B, True),
                             ("full", TF_B, False),
                             ("causal_4x_batch", 4 * TF_B, True)):
        H, T = TF_CONFIG["n_heads"], TF_T
        _, k, v, qh, do = flash_inputs(torch, fa, B, H, T, T, D, seed=7)
        o, lse = fa._flash_fwd_cuda(qh, k, v, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
        for name, fn, flops in (
                ("flash_fwd", lambda: fa._flash_fwd_cuda(qh, k, v, causal),
                 4 * D * pairs),
                ("flash_dq", lambda: fa._flash_dq_cuda(
                    qh, k, v, do, lse, delta, causal, scale), 6 * D * pairs),
                ("flash_dkv", lambda: fa._flash_dkv_cuda(
                    qh, k, v, do, lse, delta, causal), 8 * D * pairs)):
            ms, _ = kernel_ms(torch, fn)
            out[f"{name}/{label}"] = {"shape": [B, H, T, D], "ms": ms,
                                      "tflops": flops / ms / 1e9}
        del k, v, qh, do, o, lse, delta
    print(json.dumps({"flash_scaling": out}))


def ptxas_report(kc, rs):
    """Phase 1: each kernel's registers and spill bytes from this run's
    builds (``nvcc -Xptxas -v``), one JSON line.  Fails if a flash kernel
    instantiation, the onesweep kernel of the radix library or of its
    tile-size variants, the plan kernel of the radix library or of its
    tile-size variant, or a tokenize or segreduce kernel of the default
    build or of a tile variant spills.  A library built by an earlier
    process left no log here, and is not checked."""
    usage = {name: kc.ptxas_usage(log)
             for name, log in kc.BUILD_LOGS.items()}
    print(json.dumps({"ptxas": usage}))

    def no_spills(kernels):
        return kernels and all(
            u.get("spill_stores") == 0 and u.get("spill_loads") == 0
            and u.get("registers", 0) > 0 for u in kernels.values())

    checked = {kc.build_label("radix", d)
               for d in [*sort_variants(rs).values(),
                         *plan_variants(kc).values()]}
    radix = {f"{lib}/{k}": u for lib, kernels in usage.items()
             if lib in checked for k, u in kernels.items()}
    if radix:
        for kernel in ("onesweep_kernel", "plan_kernel"):
            hot = {k: u for k, u in radix.items() if kernel in k}
            check(no_spills(hot), f"ptxas: a {kernel} spills or was not "
                  f"reported: {hot}")
    else:
        print("ptxas: radix.cu was built earlier; spills not checked")
    # the scan kernels: tokenize for 1-3 lanes, segreduce for 1-3 lanes
    # and unit mode, in the default build and each tile variant
    for src, count in (("tokenize", 3), ("segreduce", 4)):
        for lib in [kc.build_label(src, d)
                    for d in scan_variants(kc, src).values()]:
            kernels = usage.get(lib)
            if kernels is None:
                print(f"ptxas: {lib} was built earlier; spills not checked")
                continue
            check(len(kernels) == count and no_spills(kernels),
                  f"ptxas: a {lib} kernel spills or was not reported: "
                  f"{kernels}")
    flash = usage.get("flash_attention")
    if flash is None:
        print("ptxas: flash_attention.cu was built earlier; spills not "
              "checked")
        return
    # three kernels, each for bf16 and fp16 and 64- and 128-wide heads
    check(len(flash) == 12 and no_spills(flash),
          f"ptxas: a flash kernel spills or was not reported: {flash}")


def _tf_group(name):
    if "mr_flash_kernels" in name:
        return "flash kernels"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "copy" in low:
        return "copies and casts"
    if "reduce" in low:
        return "reductions"
    return "other elementwise"


def logits_phase(torch, cfg):
    """What the f32-result logits product costs: ``[B*T, E] @ [E, V]``
    with bf16 operands as one GEMM writing f32 (``torch.mm(out_dtype=)``,
    the port's choice), as the plain bf16 GEMM (bf16 result), and with
    both operands upcast to f32 (an f32 GEMM)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((TF_B * TF_T, cfg.embed), generator=g,
                    device="cuda").to(cfg.dtype)
    w = torch.randn((cfg.embed, cfg.vocab), generator=g,
                    device="cuda").to(cfg.dtype)
    xf, wf = x.float(), w.float()
    times = {
        "out_dtype_f32_ms": time_ms(torch, lambda: torch.mm(
            x, w, out_dtype=torch.float32)),
        "bf16_ms": time_ms(torch, lambda: torch.mm(x, w)),
        "upcast_f32_ms": time_ms(torch, lambda: torch.mm(xf, wf), reps=5,
                                 rounds=3)}
    print(json.dumps({"logits_matmul": dict(
        shape=[TF_B * TF_T, cfg.embed, cfg.vocab], **times)}))


def trainer_phase(torch, kc, fa, tmod):
    """Phase 9: the transformer slice; returns the flash launch counts of
    its counted steps."""
    import numpy as np

    cfg = tmod.TransformerConfig(**TF_CONFIG)
    tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                 device="cuda")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(TF_B, TF_T + 1)).astype(np.int32)
    t0 = time.monotonic()
    params = tr.init_params()
    p0 = {n: t.clone() for n, t in params.state_dict().items()}
    n_params = sum(t.numel() for t in p0.values())
    init_s = time.monotonic() - t0

    # the step-0 loss on random targets is about ln(vocab) + s2 / 2, s2 the
    # logits' variance over the vocabulary: the model has no final norm,
    # so s2 is |hidden|^2 / embed, well above 0 at this depth
    with torch.no_grad():
        hidden, _ = tmod.forward_local(params, tr.place_batch(toks)[0], cfg)
        logits = torch.matmul(hidden.to(cfg.dtype).float(),
                              params.unembed.to(cfg.dtype).float())
        s2 = float(logits.var(dim=-1).mean())
        del hidden, logits
    expected = math.log(cfg.vocab) + s2 / 2

    # step 0 through the kernels (also the warm step), then the same step
    # with the flash wrappers swapped for their plain versions
    t0 = time.monotonic()
    params, loss = tr.step(params, toks)
    loss_k = float(loss)
    first_s = time.monotonic() - t0
    check(math.isfinite(loss_k) and abs(loss_k - expected) < 2,
          f"trainer: step-0 loss {loss_k} not within 2 of ln(vocab) + "
          f"s2/2 = {expected} (s2 = {s2})")
    ref = tmod.Transformer(cfg, device="cuda")
    ref.load_state_dict(p0)
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain)
    try:
        ref, loss = tr.step(ref, toks)
        loss_p = float(loss)
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = kernels
    upd_err = {}
    pk, pp = params.state_dict(), ref.state_dict()
    for n in p0:
        dk, dp = pk[n] - p0[n], pp[n] - p0[n]
        upd_err[n] = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
    worst = max(upd_err, key=upd_err.get)
    check(abs(loss_k - loss_p) < STEP_LOSS_ATOL,
          f"trainer: step-0 loss {loss_k} through the kernels, {loss_p} "
          "through the plain versions")
    check(upd_err[worst] < STEP_UPDATE_RTOL,
          f"trainer: {worst}'s update differs by {upd_err[worst]} of its "
          "norm from the plain-attention step")
    del ref, pk, pp, p0

    # the counted run: TF_STEPS steps through the kernels
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TF_STEPS):
        t0 = time.monotonic()
        params, loss = tr.step(params, toks)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss))
    launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    plain = dict(kc.PLAIN_CALLS)
    check(all(launches[k] > 0 for k in FLASH_KERNELS),
          f"trainer: a flash kernel was never launched: {launches}")
    check(all(v == 0 for v in plain.values()),
          f"trainer: plain versions ran on the card path: {plain}")
    check(all(math.isfinite(x) for x in losses), f"trainer: {losses}")
    step_s = statistics.median(times)
    flops = tmod.train_flops(cfg, n_params, TF_B, TF_T)
    print(json.dumps({"slice_transformer": {
        "config": TF_CONFIG, "batch": TF_B, "seq_len": TF_T,
        "params": n_params, "init_s": init_s, "first_step_s": first_s,
        "step0_loss": loss_k, "step0_loss_plain": loss_p,
        "step0_logit_var": s2, "step0_loss_expected": expected,
        "step0_update_rel_err_max": upd_err[worst],
        "step0_update_rel_err_worst": worst,
        "losses": losses, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": TF_B * TF_T / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS_PER_S,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "plain_calls": plain}}))

    state = {"params": params}

    def one_step():
        state["params"], _ = tr.step(state["params"], toks)

    groups, _ = device_profile(torch, "profile_transformer", one_step,
                               _tf_group)
    check(groups.get("flash kernels", 0) > 0,
          f"profile_transformer: no flash-kernel device time: {groups}")
    logits_phase(torch, cfg)
    return launches


def percentile(values, q):
    """The nearest-rank *q* quantile of *values*."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def acc_bytes(sess, task):
    """Device bytes of one resident stream's accumulator lanes."""
    return sum(t.numel() * t.element_size()
               for t in sess._streams[task].acc)


def check_launches(launches, plain, label, radix):
    need = WORDCOUNT_KERNELS if radix else ("tokenize", "segreduce")
    check(all(launches[k] > 0 for k in need),
          f"{label}: a kernel of the path was never launched: {launches}")
    check(not any(plain.values()),
          f"{label}: plain versions ran on the card path: {plain}")


def sustained_case(torch, kc, wcmod, smod, Partitions, parts, sort_impl,
                   tenants):
    """Phase 8a: bench.py's measure_sustained at full size on *parts*
    partitions.  Each tenant's first feed and snapshot (the first
    result), then 2 x SESSION_ROUNDS rounds of the three tenants' feeds
    interleaved, the rounds alternating between one overflow read a
    feed (the port's) and one after every wave (the JAX feed's, by a
    wrapper of the engine's wave here), each feed followed by the
    tenant's snapshot, and last every tenant's snapshot once more (the
    aged reads).  After the timed work, every snapshot is held against
    Counter of exactly its tenant's words times the feeds it had folded.
    Returns the case's numbers."""
    from dataclasses import replace

    import numpy as np

    from mapreduce_tpu_torch.engine.device_engine import EngineConfig

    cfg = replace(EngineConfig(**SESSION_CONFIG), sort_impl=sort_impl)
    if parts == 1:
        # one partition routes every local unique to itself: the
        # bench's per-pair exchange capacity (1<<15) cannot hold a 1 MB
        # chunk's ~35K distinct words, so it takes the local capacity
        cfg = replace(cfg, exchange_capacity=cfg.local_capacity)
    sess = smod.EngineSession(Partitions(parts, "cuda"),
                              wcmod._wordcount_map_fn, cfg)
    first = tenants[SESSION_TENANTS[0]][0]
    row_bytes = first.nbytes // first.shape[0]
    # k from the full feed (bench.py's rule), not from the warm feed
    sess.k = max(1, min(sess.engine._rows_per_wave(row_bytes),
                        -(-first.shape[0] // parts)))
    sess.feed(first[:parts], task="warm")
    sess.snapshot("warm")
    sess.close("warm")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fed = dict.fromkeys(SESSION_TENANTS, 0)
    done_at = {}
    snap_s, stale, peaks = [], [], []
    taken = []  # (label, task, feeds folded, snapshot), checked last
    real_wave = sess.engine._wave

    def wave_then_read(*args):
        out = real_wave(*args)
        int(out.overflow.sum())  # the JAX feed's per-wave readback
        return out

    def feed(task):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        sess.feed(tenants[task][0], task=task)
        done_at[task] = time.monotonic()
        peaks.append(torch.cuda.max_memory_allocated() - before)
        fed[task] += 1
        return done_at[task] - t0

    def snapshot(task, label):
        t0 = time.monotonic()
        snap = sess.snapshot(task)
        t1 = time.monotonic()
        snap_s.append(t1 - t0)
        stale.append(t1 - done_at[task])
        taken.append((label, task, fed[task], snap))
        return t1

    kc.reset_counts()
    first_result = []
    for task in SESSION_TENANTS:
        t0 = time.monotonic()
        feed(task)
        first_result.append(snapshot(task, "first") - t0)
    resident = {t: acc_bytes(sess, t) for t in SESSION_TENANTS}
    torch.cuda.synchronize()
    per_stream = (torch.cuda.memory_allocated() - base) / len(
        SESSION_TENANTS)
    walls = {"feed": [], "wave": []}
    for r in range(2 * SESSION_ROUNDS):
        read = "wave" if r % 2 else "feed"
        sess.engine._wave = wave_then_read if r % 2 else real_wave
        try:
            for task in SESSION_TENANTS:
                walls[read].append(feed(task))
                snapshot(task, f"sustained P={parts} round {r}")
        finally:
            sess.engine._wave = real_wave
    for task in SESSION_TENANTS:  # the aged reads (bench.py phase 3)
        snapshot(task, f"sustained P={parts} aged")
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, f"sustained P={parts}",
                   sort_impl == "radix")
    for label, task, n, snap in taken:
        chunks, want, _ = tenants[task]
        check(snap.overflow == 0, f"{label}: {task} overflowed")
        got = wcmod.materialize_counts(np.concatenate([chunks] * n), snap)
        check(got == {w: c * n for w, c in want.items()},
              f"{label}: tenant {task}'s counts differ from Counter of "
              f"its own words x {n}")
    records = SESSION_ROUNDS * sum(t[2] for t in tenants.values())
    waves = sum(sess.stats(t)["waves"] for t in SESSION_TENANTS)
    sess.close()
    return {
        "partitions": parts, "sort_impl": sort_impl, "k": sess.k,
        "exchange_capacity": cfg.exchange_capacity,
        "records_per_s": records / sum(walls["feed"]),
        "records_per_s_per_wave_read": records / sum(walls["wave"]),
        "records_a_mode": records, "feeds_a_mode": len(walls["feed"]),
        "waves": waves,
        "feed_wall_p50_s": percentile(walls["feed"], 0.5),
        "feed_wall_p99_s": percentile(walls["feed"], 0.99),
        "feed_wall_p50_s_per_wave_read": percentile(walls["wave"], 0.5),
        "first_snapshot_s": first_result,
        "snapshot_p50_s": percentile(snap_s, 0.5),
        "snapshot_p99_s": percentile(snap_s, 0.99),
        "staleness_p50_s": percentile(stale, 0.5),
        "staleness_p99_s": percentile(stale, 0.99),
        "resident_bytes_per_stream": resident,
        "memory_allocated_per_stream": per_stream,
        "feed_peak_over_resident_bytes": max(peaks),
        "launches": launches}


def session_host_matrix(hashes, chunks, feeds, k, P, tables):
    """The traffic matrix a session accumulates, recomputed on the host:
    per feed, per wave, entry [src][dst] counts the distinct word keys
    of partition src's real rows routed to dst through that feed's
    table (*hashes*: word -> (k1, k2))."""
    import numpy as np

    matrix = np.zeros((P, P), dtype=np.int64)
    for (lo, hi), table in zip(feeds, tables):
        B = table.shape[0]
        for w in range(-(-(hi - lo) // (k * P))):
            for d in range(P):
                a = lo + w * k * P + d * k
                words = set()
                for row in chunks[a:min(a + k, hi)]:
                    words.update(row.tobytes().split())
                for k1, _k2 in {hashes[wd] for wd in words}:
                    matrix[d, int(table[k1 % B])] += 1
    return matrix


def flagship_session(torch, kc, wcmod, smod, spill, router, Partitions,
                     plan_rebalance, tok, chunks, want):
    """Phase 8b: the flagship config as a session at P = 8 on the radix
    path with a partition map: the 24 chunks in SESSION_FEEDS feeds, a
    rebalance after the second to a plan_rebalance table of the
    stream's own bucket histogram after the first, the last two feeds
    profiled (uploads pinned and off the kernels' stream); then an evict
    and the lazy
    restore of the next snapshot (bench.py's measure_session_restore),
    and a resident cap of one evicting the colder stream."""
    from dataclasses import replace

    import numpy as np

    P = RADIX_PARTS
    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix",
                  partition_map=True)
    store = spill.SessionSpillStore(router("mem:chip-smoke"))
    sess = smod.EngineSession(Partitions(P, "cuda"),
                              wcmod._wordcount_map_fn, cfg, spill=store)
    per = chunks.shape[0] // SESSION_FEEDS
    feeds = [(i * per, (i + 1) * per) for i in range(SESSION_FEEDS)]
    sess.feed(chunks[:P], task="warm")
    sess.close("warm")
    B = sess.engine.partition_buckets
    table = np.arange(B, dtype=np.int32) % P
    tables = []
    kc.reset_counts()
    for i, (lo, hi) in enumerate(feeds[:2]):
        if i == 1:
            table = plan_rebalance(sess.bucket_histogram("flag"), P)
            t0 = time.monotonic()
            sess.rebalance("flag", table)
            rebalance_s = time.monotonic() - t0
        tables.append(table)
        sess.feed(chunks[lo:hi], task="flag")
    tables += [table] * (len(feeds) - 2)

    def last_feeds():
        for lo, hi in feeds[2:]:
            sess.feed(chunks[lo:hi], task="flag")

    # the feeds after the table's upload (the second feed's), profiled
    waves0, before = sess.stats("flag")["waves"], dict(kc.LAUNCHES)
    _, events = device_profile(
        torch, "profile_session", last_feeds, _profile_group,
        on_trace=lambda ev: upload_report(
            "profile_session", ev,
            expect=sess.stats("flag")["waves"] - waves0))
    profiled = {k: kc.LAUNCHES[k] - before[k] for k in WORDCOUNT_KERNELS}
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "flagship session", True)
    check(np.array_equal(sess.partition_map("flag"), table)
          and not np.array_equal(table, tables[0]),
          "flagship session: the rebalance changed no routing")
    t0 = time.monotonic()
    snap = sess.snapshot("flag")
    snapshot_s = time.monotonic() - t0
    check(wcmod.materialize_counts(chunks, snap) == want,
          "flagship session: counts differ from Counter(data.split())")
    hashes = tok.word_hashes_host(b" ".join(want))
    matrix = sess.traffic_matrix("flag")
    check(np.array_equal(matrix, session_host_matrix(
        hashes, chunks, feeds, sess.k, P, tables)),
        "flagship session: traffic matrix differs from the host "
        "recompute under the two tables")
    resident = acc_bytes(sess, "flag")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("keys", "values", "payload", "valid"))

    t0 = time.monotonic()
    sess.evict("flag")
    spill_s = time.monotonic() - t0
    check(sess.tasks() == [], "flagship session: evict left the stream")
    t0 = time.monotonic()
    restored = sess.snapshot("flag")  # the lazy restore
    restore_s = time.monotonic() - t0
    check(same(restored, snap), "flagship session: the restored snapshot "
          "differs from the one before the evict")
    sess.feed(chunks[:per], task="side")
    sess.spill_policy = spill.SpillPolicy(max_resident=1)
    sess.feed(chunks[per:2 * per], task="side")
    check(sess.tasks() == ["side"] and store.has("flag"),
          f"flagship session: the resident cap kept {sess.tasks()}")
    check(same(sess.snapshot("flag"), snap),
          "flagship session: restored after the cap, the snapshot differs")
    return {"partitions": P, "feeds": len(feeds), "k": sess.k,
            "buckets": B, "rebalance_s": rebalance_s,
            "snapshot_s": snapshot_s, "session_spill_s": spill_s,
            "session_restore_s": restore_s,
            "resident_bytes": resident,
            "spilled_bytes": sum(len(store.storage.read_bytes(n))
                                 for n in store.storage.list(r"\.npy$")),
            "col_sums": matrix.sum(axis=0).tolist(),
            "launches": launches, "profiled_launches": profiled,
            "profiled_events": events}


def topk_session(torch, kc, wcmod, topk, Partitions, data):
    """Phase 8c: TopKWords(k=100) over the corpus in SESSION_FEEDS
    feeds (cut at whitespace) on the radix path at P = 8, equal to
    host_topk."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
    tk = topk.TopKWords(Partitions(RADIX_PARTS, "cuda"), k=TOPK_K,
                        chunk_len=CHUNK_LEN, config=cfg)
    parts, lo = [], 0
    for i in range(1, SESSION_FEEDS + 1):
        hi = len(data) * i // SESSION_FEEDS
        while hi < len(data) and data[hi] not in b" \n\t\r\x0b\x0c":
            hi += 1
        parts.append(data[lo:hi])
        lo = hi
    kc.reset_counts()
    t0 = time.monotonic()
    for part in parts:
        tk.feed(part)
    feed_s = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "topk", True)
    t0 = time.monotonic()
    top = tk.topk()
    topk_s = time.monotonic() - t0
    check(top == topk.host_topk(data, TOPK_K),
          "topk: differs from host_topk")
    return {"k": TOPK_K, "feeds": len(parts), "feed_s": feed_s,
            "topk_s": topk_s, "top3": [[w.decode(), c] for w, c in top[:3]],
            "launches": launches}


def session_phase(torch, kc, wcmod, Partitions, plan_rebalance, tok, data,
                  chunks, want, smi):
    """Phase 8: the resident sessions (the ``session`` line)."""
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine import topk
    from mapreduce_tpu_torch.storage.router import router

    tenants = {}
    for seed, task in enumerate(SESSION_TENANTS):
        text = make_corpus(SESSION_WORDS, SESSION_WORDS // 25, seed=seed)
        rows, _ = tok.shard_text(
            text, -(-len(text) // SESSION_CHUNK_LEN), pad_multiple=512,
            pad_to=SESSION_CHUNK_LEN + 512)
        tenant_want = Counter(text.split())
        tenants[task] = (rows, tenant_want, sum(tenant_want.values()))
    def part(name, value):
        # each part as it ends (a failure later keeps the earlier ones)
        print(json.dumps({"session_part": {name: value}}), flush=True)
        return value

    out = {"card": smi, "sustained": [
        part(f"sustained_p{parts}", sustained_case(
            torch, kc, wcmod, smod, Partitions, parts, impl, tenants))
        for parts, impl in ((1, "variadic"), (RADIX_PARTS, "radix"))]}
    out["flagship"] = part("flagship", flagship_session(
        torch, kc, wcmod, smod, spill, router, Partitions, plan_rebalance,
        tok, chunks, want))
    out["topk"] = part("topk", topk_session(torch, kc, wcmod, topk,
                                            Partitions, data))
    print(json.dumps({"session": out}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import tiering
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.ops import flash_attention as fa
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.ops import tokenize as tok
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    # phase 1: build, and the card
    t0 = time.monotonic()
    variants = [("radix", d) for d in [*sort_variants(rs).values(),
                                       *plan_variants(kc).values()] if d]
    variants += [(src, d) for src in SCAN_TILE_DEFINES
                 for d in scan_variants(kc, src).values() if d]
    kc.build_all(variants)
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(kc.SOURCES)} sources and {len(variants)} variants in "
          "parallel)")
    ptxas_report(kc, rs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    data = make_corpus(N_WORDS, N_WORDS * N_LINES // EUROPARL_WORDS, seed=0)
    print(f"corpus: {len(data)} bytes, {N_WORDS} words (seed 0) in "
          f"{time.monotonic() - t0:.2f} s")
    cfg = wcmod.bench_engine_config()
    wc = wcmod.DeviceWordCount(device="cuda", chunk_len=CHUNK_LEN,
                               config=cfg)
    chunks, L = wc._to_chunks(data)
    check(chunks.shape[0] == 24, f"expected 24 chunks, got {chunks.shape}")
    chunks_dev = torch.from_numpy(chunks[:2 * RADIX_PARTS]).to(dev)

    # phases 2-3: each kernel against its plain version
    kernels = [tokenize_phase(torch, kc, tok, chunks_dev[0]),
               segreduce_phase(torch, kc, seg, wcmod, chunks_dev,
                               wc.config)]
    # the radix phase's inputs, made by the path from the same chunks
    radix_in, radix_dest = radix_inputs(torch, seg, wcmod, chunks_dev,
                                        wc.config)
    del chunks_dev

    # phase 4: the slice, warm once; the bench's staged path; then the
    # counted streaming run
    want = Counter(data.split())
    wc.count_bytes(data)
    staged_phase(torch, kc, wc, data, want)
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_bytes(data, timings=tm)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    check(got == want, "word counts differ from Counter(data.split())")
    k = chunks.shape[0] // tm["waves"]
    check(tm["waves"] == 2 and k == 12, f"expected 2 waves of 12 chunks, "
          f"got {tm['waves']}")
    check(launches["tokenize"] >= 24, f"tokenize launches {launches}")
    check(launches["segreduce"] >= 2 * (k + 2),
          f"segreduce launches {launches}")
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the card path: {plain}")
    engine = wc.engine
    wave_bytes = k * engine.n_dev * chunks.nbytes // chunks.shape[0]
    check(tm["peak_input_wave_bytes"]
          <= engine.STREAM_PREFETCH * wave_bytes,
          f"streaming run held {tm['peak_input_wave_bytes']} input bytes, "
          f"over {engine.STREAM_PREFETCH} waves of {wave_bytes}")
    n_words = sum(want.values())
    print(json.dumps({"slice": {
        "words": n_words, "unique": len(want), "bytes": len(data),
        "waves": tm["waves"], "retries": tm["retries"],
        "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
        "readback_s": tm["readback_s"], "materialize_s": tm["materialize_s"],
        "wall_s": wall, "words_per_s_compute": n_words / tm["compute_s"],
        "first_dispatch_s": tm["first_dispatch_s"],
        "peak_input_wave_bytes": tm["peak_input_wave_bytes"],
        "input_bytes": tm["input_bytes"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "plain_calls": plain}}))

    # a small collision-verify count: the 3-lane kernels through the engine
    part = data[:3_000_000]
    vwc = wcmod.DeviceWordCount(device="cuda", chunk_len=1 << 18,
                                verify_collisions=True)
    check(vwc.count_bytes(part) == Counter(part.split()),
          "verify-mode counts differ")
    print("verify_collisions count: equal")

    profile_phase(torch, kc, wc, chunks)

    # phase 6: the radix kernels against their plain versions
    radix_kernels, _ = radix_phase(torch, kc, rs, radix_in, radix_dest)
    del radix_in, radix_dest

    # phase 7: the radix slice over 8 partitions, profiled, and under a
    # partition map
    rwc, rlaunches, rmatrix = radix_slice_phase(torch, kc, rs, wcmod,
                                                Partitions, data, want)
    rchunks, _ = rwc._to_chunks(data)
    profile_phase(torch, kc, rwc, rchunks, label="profile_radix",
                  waves=RADIX_WAVES,
                  need=("tokenize kernel", "segreduce kernel",
                        "radix upfront", "radix onesweep", "radix plan"),
                  forbid=("torch.sort",))
    partition_map_phase(torch, wcmod, Partitions, tok, plan_rebalance, rwc,
                        data, want)
    tiered_phase(torch, kc, wcmod, tiering, Partitions, data, want, rmatrix)

    # phase 8: the resident sessions
    session_phase(torch, kc, wcmod, Partitions, plan_rebalance, tok, data,
                  chunks, want, smi)

    # phases 8-9: the flash kernels, then the transformer slice (the
    # plain f32 matmuls of the reference stay in full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_kernels = flash_phase(torch, fa)
    flash_scaling(torch, fa)
    flaunches = trainer_phase(torch, kc, fa, tmod)

    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    for kern in radix_kernels:
        kern["launches"] = rlaunches[kern["name"]]
    for kern in flash_kernels:
        kern["launches"] = flaunches[kern["name"]]
    kernels += radix_kernels + flash_kernels
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold"]:
        sys.exit(cold_child(sys.argv[2]))
    sys.exit(main())
