#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (mapreduce_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and in a directory
that holds this script and nothing else of the repo).  Phases, each of
which raises on failure:

1. build the CUDA kernels from ``mapreduce_tpu_torch/csrc`` (one nvcc per
   source, started together) and print the card's name and power limit;
2. the tokenize kernel against its plain PyTorch version on one
   full-width chunk (4,194,816 bytes of the synthetic corpus): bit
   equality, then kernel / plain times beside the memory bound (the
   kernel as 20 launches replayed from one CUDA graph, see
   :func:`kernel_ms`);
3. the segmented-reduce kernel against its plain version at the main
   path's shapes (the per-chunk combiner, the local reduce, the fold,
   and the 3-lane collision-verify monoid), with the same timings and
   ``torch.unique_consecutive`` as the library yardstick of the unit
   case (timed here only; the port never calls it);
4. the slice: ``DeviceWordCount(device="cuda", chunk_len=1<<22,
   config=bench_engine_config())`` over 16M words of the synthetic
   Europarl-shaped corpus (24 chunks, two 12-chunk waves, so the
   accumulator carries across waves), counts held against
   ``collections.Counter(data.split())``, launch counters read around
   the run; then a small collision-verify count;
5. one more slice run under ``torch.profiler``: device time by group
   (the kernels, the library sort, host-to-device copies, the rest),
   counted over device-side events only, and the device busy share
   (device time over the profiled run's wall time, a floor, since the
   profiler lengthens that wall time);
6. the radix kernels against their plain versions on inputs the radix
   path makes from the corpus: ``radix_sort_pairs`` at the combiner's
   852,072 rows, the local sort's 262,144 and the fold's 1,310,720 (also
   against ``torch.sort``'s stable permutation of the packed key, the
   library yardstick), one pass's hist and scatter at the combiner and
   fold shapes, and ``radix_partition_plan`` over ``[8, 262,144]`` with
   9 buckets; kernel, plain and library times beside the memory bound;
7. the radix slice: ``DeviceWordCount(Partitions(8, "cuda"),
   chunk_len=1<<22, config=replace(bench_engine_config(),
   sort_impl="radix"))`` over the same corpus with ``waves=2``: counts
   against ``Counter(data.split())``, the 8 x 8 traffic matrix against
   ``host_exchange_matrix``, launches of all five kernels and no plain
   call, then a profiled run (no ``torch.sort`` device time) and a run
   under a ``plan_rebalance`` partition map (same counts, the matrix
   against the host recompute under that table);
8. one JSON line of per-kernel numbers, then the result line.

Every comparison is integer and exact (tolerance: none).
"""

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

#: the card's published memory rate (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 ALU rate taken as the fp32 non-tensor peak (H100 SXM, 67 TFLOP/s)
INT_OPS_PER_S = 67e12
CHUNK_LEN = 1 << 22
#: words of the smoke corpus: 24 chunks of 1<<22 bytes (a cut of
#: Europarl's 49M words to fit the smoke's time limit)
N_WORDS = 16_000_000
REPS = 20
#: the radix slice: partitions on the one card, and waves
RADIX_PARTS = 8
RADIX_WAVES = 2


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


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want):
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def tokenize_phase(torch, tok, chunk):
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
    print(f"tokenize n={n} lanes={nl}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "tokenize", "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/tokenize.cu",
            "replaces": "mapreduce_tpu/ops/tokenize.py:197",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def segreduce_case(torch, seg, label, k1s, k2s, vals, op, unit):
    """One segreduce shape: equality on the surface (reduced lanes at run
    ends, end_csum everywhere) and timings."""
    got = seg._segment_reduce_cuda(k1s, k2s, vals, op, unit)
    want = seg._segment_reduce_plain(k1s, k2s, vals, op, unit)
    torch.cuda.synchronize()
    _, _, is_end = seg._run_flags(k1s, k2s)
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
    print(f"segreduce {label} n={n}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"label": label, "n": n, "max_abs_err": err, "ms": ms,
            "spread": spread, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def segreduce_phase(torch, seg, wcmod, chunks_dev, cfg):
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

    ucfg = replace(cfg, unit_values=True, reduce_op="sum")
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn(chunks_dev[0], 0,
                                                        ucfg)
    k1s, k2s, _ = sorted_lanes(keys, valid, [])
    cases = [segreduce_case(torch, seg, "combiner/unit", k1s, k2s, [],
                            "sum", True)]
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
    cases.append(segreduce_case(torch, seg, "local/sum", k1s, k2s, vs,
                                "sum", False))

    local = seg.sorted_unique_reduce(
        buf_k, buf_v, torch.zeros((buf_k.shape[0], 1), dtype=torch.int32,
                                  device=buf_k.device),
        buf_valid, cfg.out_capacity, "sum")
    ex = cfg.exchange_capacity
    fk = torch.cat([local.keys, local.keys[:ex]])
    fv = torch.cat([local.values, local.values[:ex]])
    fvalid = torch.cat([local.valid, local.valid[:ex]])
    k1s, k2s, vs = sorted_lanes(fk, fvalid, [fv])
    cases.append(segreduce_case(torch, seg, "fold/sum", k1s, k2s, vs,
                                "sum", False))

    vcfg = replace(cfg, unit_values=False, reduce_op=wcmod.VERIFY_REDUCE_OP)
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn_verify(
        chunks_dev[0], 0, vcfg)
    k1s, k2s, vs = sorted_lanes(keys, valid,
                                [vals[:, i] for i in range(3)])
    cases.append(segreduce_case(torch, seg, "verify/(sum,min,max)", k1s, k2s,
                                vs, wcmod.VERIFY_REDUCE_OP, False))
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
        return "radix kernels"
    low = name.lower()
    if "sort" in low and "searchsorted" not in low:
        return "torch.sort"
    if "memcpy htod" in low:
        return "upload (memcpy HtoD)"
    return "other"


def profile_phase(torch, wc, chunks, label="profile", waves=None,
                  need=("tokenize kernel", "segreduce kernel"), forbid=()):
    """One engine run of a slice under torch.profiler; prints device
    microseconds by group and the 12 largest device events.  Fails if a
    group in *need* shows no device time or one in *forbid* shows any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = wc._engine_for(chunks.shape[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.run(chunks, waves=waves)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    groups, rows = {}, []
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
        g = _profile_group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
        rows.append((dev_us, ev.count, ev.key[:100], g))
    device_us = sum(groups.values())
    check(all(groups.get(g, 0) > 0 for g in need),
          f"{label}: profiled run shows no device time in {need}: {groups}")
    check(all(groups.get(g, 0) == 0 for g in forbid),
          f"{label}: profiled run shows device time in {forbid}: {groups}")
    rows.sort(reverse=True)
    print(json.dumps({label: {
        "wall_us": wall_us, "device_us_total": device_us,
        "busy_share": device_us / wall_us, "device_us": groups,
        "top": [{"device_us": r[0], "calls": r[1], "name": r[2],
                 "group": r[3]} for r in rows[:12]]}}))


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
    """One LSD pass's hist and scatter (the digit of a second pass, with
    a permutation lane) against the plain versions, and their times."""
    n = k1.numel()
    tiles = -(-n // rs.RADIX_TILE)
    perm = torch.randperm(n, device=k1.device).to(torch.int32)
    src = k2[None]
    got_h = rs._radix_hist_cuda(src, 8, 0xFF, rs.RADIX)
    want_h = rs._radix_hist_plain(src, 8, 0xFF, rs.RADIX)
    check(torch.equal(got_h, want_h), f"radix_hist {label} differs")
    got = tuple(torch.empty(n, dtype=torch.int32, device=k1.device)
                for _ in range(3))
    want = tuple(torch.empty_like(g) for g in got)
    rs._radix_scatter_cuda(k1, k2, perm, 1, 8, got_h, got)
    rs._radix_scatter_plain(k1, k2, perm, 1, 8, want_h, want)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"radix_scatter {label} differs")
        err = max(err, max_abs_err(torch, g, w))
    h_ms, h_spread = kernel_ms(torch, lambda: rs._radix_hist_cuda(
        src, 8, 0xFF, rs.RADIX))
    h_plain = time_ms(torch, lambda: rs._radix_hist_plain(
        src, 8, 0xFF, rs.RADIX), reps=5, rounds=3)
    # library yardstick: one bincount over tile * R + digit (the index
    # made beforehand; the port never calls bincount)
    idx = ((torch.arange(n, device=k1.device) // rs.RADIX_TILE) * rs.RADIX
           + ((k2.to(torch.int64) & 0xFFFFFFFF) >> 8) % rs.RADIX)
    h_lib = time_ms(torch, lambda: torch.bincount(
        idx, minlength=tiles * rs.RADIX))
    s_ms, s_spread = kernel_ms(torch, lambda: rs._radix_scatter_cuda(
        k1, k2, perm, 1, 8, got_h, got))
    s_plain = time_ms(torch, lambda: rs._radix_scatter_plain(
        k1, k2, perm, 1, 8, want_h, want), reps=2, rounds=3)
    # bytes, each input read once and each output written once: hist
    # reads the digit lane and writes R x tiles counts; scatter reads
    # (k1, k2, perm) and the counts, writes (k1, k2, perm)
    hist_bytes = 4 * rs.RADIX * tiles
    hb_ms, hb_by = bound(4 * n + hist_bytes, 4 * n)
    sb_ms, sb_by = bound(24 * n + hist_bytes, 12 * n)
    case = {"label": label, "n": n, "max_abs_err": err,
            "hist": {"ms": h_ms, "spread": h_spread, "plain_ms": h_plain,
                     "library_ms": h_lib, "bound_ms": hb_ms,
                     "bound_by": hb_by},
            "scatter": {"ms": s_ms, "spread": s_spread, "plain_ms": s_plain,
                        "library_ms": None, "bound_ms": sb_ms,
                        "bound_by": sb_by}}
    print(json.dumps({"radix_pass_case": case}))
    return case


def radix_sort_case(torch, rs, label, k1, k2):
    """The whole sort against the plain passes and torch.sort."""
    n = k1.numel()
    got = rs.radix_sort_pairs(k1, k2)
    want = rs.sort_passes(k1, k2, rs._radix_hist_plain,
                          rs._radix_scatter_plain)
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
    plain_ms = time_ms(torch, lambda: rs.sort_passes(
        k1, k2, rs._radix_hist_plain, rs._radix_scatter_plain),
        reps=1, rounds=3)
    lib_ms = time_ms(torch, lambda: torch.sort(packed, stable=True))
    # the sort as a function: reads (k1, k2), writes (k1s, k2s, perm)
    b_ms, b_by = bound(20 * n, 0)
    case = {"label": label, "n": n, "ms": ms, "spread": spread,
            "plain_ms": plain_ms, "torch_sort_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "passes": rs.RADIX_PASSES}
    print(json.dumps({"radix_sort_case": case}))
    return case


def radix_plan_case(torch, rs, dest):
    """The plan over [8, 262,144] with 9 buckets: hist and rank against
    their plain versions, and their times."""
    b, n = dest.shape
    nb = RADIX_PARTS + 1
    tiles = -(-n // rs.RADIX_TILE)
    got_h = rs._radix_hist_cuda(dest, 0, 0xFFFFFFFF, nb)
    want_h = rs._radix_hist_plain(dest, 0, 0xFFFFFFFF, nb)
    check(torch.equal(got_h, want_h), "radix_hist (plan) differs")
    got = rs._radix_rank_cuda(dest, got_h, nb)
    want = rs._radix_rank_plain(dest, want_h, nb)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(torch.equal(g, w), "radix_rank differs")
        err = max(err, max_abs_err(torch, g, w))
    h_ms, h_spread = kernel_ms(torch, lambda: rs._radix_hist_cuda(
        dest, 0, 0xFFFFFFFF, nb))
    r_ms, r_spread = kernel_ms(torch, lambda: rs._radix_rank_cuda(
        dest, got_h, nb))
    r_plain = time_ms(torch, lambda: rs._radix_rank_plain(dest, want_h, nb),
                      reps=5, rounds=3)
    hist_bytes = 4 * b * nb * tiles
    hb_ms, hb_by = bound(4 * b * n + hist_bytes, 4 * b * n)
    rb_ms, rb_by = bound(8 * b * n + hist_bytes + 4 * b * nb, 12 * b * n)
    case = {"label": "plan", "shape": [b, n], "buckets": nb,
            "max_abs_err": err,
            "hist": {"ms": h_ms, "spread": h_spread, "bound_ms": hb_ms,
                     "bound_by": hb_by},
            "rank": {"ms": r_ms, "spread": r_spread, "plain_ms": r_plain,
                     "library_ms": None, "bound_ms": rb_ms,
                     "bound_by": rb_by}}
    print(json.dumps({"radix_plan_case": case}))
    return case


def radix_phase(torch, rs, inputs, dest):
    """Phase 6: returns the three radix kernels' records."""
    sorts = [radix_sort_case(torch, rs, label, *inputs[label])
             for label in ("combiner", "local", "fold")]
    passes = [radix_pass_case(torch, rs, label, *inputs[label])
              for label in ("combiner", "fold")]
    plan = radix_plan_case(torch, rs, dest)
    err = max(c["max_abs_err"] for c in passes)
    head = passes[0]  # the combiner shape: 32 of the 64 sorts per run

    def record(name, line, t, error):
        return {"name": name, "route": "cuda",
                "source": "mapreduce_tpu_torch/csrc/radix.cu",
                "replaces": f"mapreduce_tpu/ops/radix_sort.py:{line}",
                "max_abs_err": error, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    return ([record("radix_hist", 96, head["hist"], err),
             record("radix_rank", 112, plan["rank"], plan["max_abs_err"]),
             record("radix_scatter", 119, head["scatter"], err)],
            {"sorts": sorts, "passes": passes, "plan": plan})


def radix_slice_phase(torch, kc, wcmod, Partitions, data, want):
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
    check(all(launches[k] > 0 for k in kc.KERNELS),
          f"radix slice: a kernel was never launched: {launches}")
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
    return wc, launches


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
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.ops import tokenize as tok
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    # phase 1: build, and the card
    t0 = time.monotonic()
    kc.build_all()
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(kc.SOURCES)} sources in parallel)")
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
    kernels = [tokenize_phase(torch, tok, chunks_dev[0]),
               segreduce_phase(torch, seg, wcmod, chunks_dev, wc.config)]
    # the radix phase's inputs, made by the path from the same chunks
    radix_in, radix_dest = radix_inputs(torch, seg, wcmod, chunks_dev,
                                        wc.config)
    del chunks_dev

    # phase 4: the slice, warm once, then the counted run
    want = Counter(data.split())
    wc.count_bytes(data)
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
    n_words = sum(want.values())
    print(json.dumps({"slice": {
        "words": n_words, "unique": len(want), "bytes": len(data),
        "waves": tm["waves"], "retries": tm["retries"],
        "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
        "readback_s": tm["readback_s"], "materialize_s": tm["materialize_s"],
        "wall_s": wall, "words_per_s_compute": n_words / tm["compute_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "plain_calls": plain}}))

    # a small collision-verify count: the 3-lane kernels through the engine
    part = data[:3_000_000]
    vwc = wcmod.DeviceWordCount(device="cuda", chunk_len=1 << 18,
                                verify_collisions=True)
    check(vwc.count_bytes(part) == Counter(part.split()),
          "verify-mode counts differ")
    print("verify_collisions count: equal")

    profile_phase(torch, wc, chunks)

    # phase 6: the radix kernels against their plain versions
    radix_kernels, _ = radix_phase(torch, rs, radix_in, radix_dest)
    del radix_in, radix_dest

    # phase 7: the radix slice over 8 partitions, profiled, and under a
    # partition map
    rwc, rlaunches = radix_slice_phase(torch, kc, wcmod, Partitions, data,
                                       want)
    rchunks, _ = rwc._to_chunks(data)
    profile_phase(torch, rwc, rchunks, label="profile_radix",
                  waves=RADIX_WAVES,
                  need=("tokenize kernel", "segreduce kernel",
                        "radix kernels"),
                  forbid=("torch.sort",))
    partition_map_phase(torch, wcmod, Partitions, tok, plan_rebalance, rwc,
                        data, want)

    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    for kern in radix_kernels:
        kern["launches"] = rlaunches[kern["name"]]
    kernels += radix_kernels
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
