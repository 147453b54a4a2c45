#!/usr/bin/env python3
"""Where the exchange plan's kernel spends its time, on one CUDA card.

    python3 probe_plan.py

Copies ``mapreduce_tpu_torch/csrc`` to ``build/probe_plan/`` (never
touching the package's sources), wraps parts of the copy's ``radix.cu``
in ``#ifdef``s, builds one variant a define set (one ``nvcc`` each, all
started together) and times each variant's ``mr_radix_plan`` in turns
(A B C ... C B A, each as chip_smoke.py's ``kernel_ms``: 20 calls
replayed from one CUDA graph):

- ``real``: the source as it is;
- ``ctas1``: ``__launch_bounds__(256)`` without the minimum of 4 CTAs
  an SM (the compiler then takes more registers);
- ``ballot``: ``tile_ranks`` groups a warp's lanes by one ballot a digit
  bit in place of ``__match_any_sync``;
- ``empty``: each CTA returns once it has its tile id (the memset,
  launch and CTA floor);
- ``no_rank``, ``no_lookback``, ``no_store`` and ``no_rank_no_lookback``:
  the in-tile rank, the look-back or the rank stores left out.

``real``, ``ctas1`` and ``ballot`` are held bit-equal to the plain
version; the other variants compute wrong results by design and time
only.  ``ballot`` changes the sort's passes too, so the whole sort is
also timed for ``real`` and ``ballot`` (bit-equal to the plain passes).
Inputs are made from seed 0: the plan's ``dest`` uniform in ``[0, P]``,
the sort's keys uniform uint32.  Prints each variant's registers and
spills, one JSON line a shape, and the card's name and power limit.
Needs one card; exits non-zero without one.
"""

import json
import os
import shutil
import subprocess
import sys

#: (name, text in radix.cu, text wrapped around it): each patch puts a
#: -D switch around one part of the kernel
PATCHES = (
    ("MR_PROBE_CTAS1", "__launch_bounds__(kThreads, kPlanCtas)",
     "\n#ifdef MR_PROBE_CTAS1\n__launch_bounds__(kThreads)\n#else\n"
     "__launch_bounds__(kThreads, kPlanCtas)\n#endif\n"),
    ("MR_PROBE_EMPTY", "  const int id = tile_id;\n",
     "  const int id = tile_id;\n#ifdef MR_PROBE_EMPTY\n"
     "  if (id >= 0) return;\n#endif\n"),
    ("MR_PROBE_NO_RANK", "  const int32_t count = tile_ranks<kPlanRounds>(",
     "#ifdef MR_PROBE_NO_RANK\n  const int32_t count = 0;\n  if (false)\n"
     "#else\n  const int32_t count =\n#endif\n  tile_ranks<kPlanRounds>("),
    ("MR_PROBE_NO_LOOKBACK", "      before = look_back(mine, tile, nb);\n",
     "#ifndef MR_PROBE_NO_LOOKBACK\n      before = look_back(mine, tile, nb);"
     "\n#endif\n"),
    ("MR_PROBE_NO_STORE", "    if (i < n) r_out[i] = wcount",
     "#ifdef MR_PROBE_NO_STORE\n    if (i < 0)\n#else\n    if (i < n)\n"
     "#endif\n    r_out[i] = wcount"),
    ("MR_PROBE_BALLOT",
     "    const unsigned peers = __match_any_sync(mr::kFull, d);\n",
     "#ifdef MR_PROBE_BALLOT\n"
     "    unsigned peers = __ballot_sync(mr::kFull, d >= 0);\n"
     "    peers = d >= 0 ? peers : ~peers;\n"
     "    for (int b = 0; b < 32 - __clz(nb - 1); ++b) {\n"
     "      const unsigned set = __ballot_sync(mr::kFull, (d >> b) & 1);\n"
     "      peers &= (d >> b) & 1 ? set : ~set;\n"
     "    }\n#else\n"
     "    const unsigned peers = __match_any_sync(mr::kFull, d);\n"
     "#endif\n"),
)
#: variant -> the switches it sets
VARIANTS = {"real": (), "ctas1": ("MR_PROBE_CTAS1",),
            "ballot": ("MR_PROBE_BALLOT",), "empty": ("MR_PROBE_EMPTY",),
            "no_rank": ("MR_PROBE_NO_RANK",),
            "no_lookback": ("MR_PROBE_NO_LOOKBACK",),
            "no_store": ("MR_PROBE_NO_STORE",),
            "no_rank_no_lookback": ("MR_PROBE_NO_RANK",
                                    "MR_PROBE_NO_LOOKBACK")}
#: the variants whose outputs are right
EXACT = ("real", "ctas1", "ballot")
#: (P, batch, n) of the plan: the P = 8 slice's shape, a longer row, and
#: the most partitions
PLAN_SHAPES = ((8, 8, 262_144), (8, 8, 852_072), (255, 2, 262_144))
#: rows of the sorts timed for real and ballot (chip_smoke.py's shapes)
SORT_NS = (852_072, 262_144, 1_310_720)


def patched_csrc(kc, root):
    """A copy of the kernel sources under *root* with every switch of
    PATCHES in its radix.cu."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kc.CSRC, root)
    path = root / "radix.cu"
    src = path.read_text()
    for name, old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"probe_plan: {name}: radix.cu no longer "
                               f"holds {old.strip()!r} once")
        src = src.replace(old, new)
    path.write_text(src)
    return root


def in_turns(torch, cs, variants, call, want):
    """Each variant's ``call(variant)``, checked against *want* where the
    variant is exact, then timed in turns: ``{variant: [ms, ms]}``."""
    out = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        res = call(v)
        torch.cuda.synchronize()
        if v in EXACT:
            cs.check(all(torch.equal(a, b) for a, b in zip(res, want)),
                     f"probe_plan: the {v} build differs")
        out[v].append(cs.kernel_ms(torch, lambda: call(v))[0])
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_plan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import radix_sort as rs

    kc.CSRC = patched_csrc(kc, kc.BUILD_DIR.parent / "probe_plan")
    defines = {v: tuple((name, 1) for name in names)
               for v, names in VARIANTS.items()}
    procs = [(d, kc._start_build("radix", d)) for d in defines.values()]
    for d, proc in procs:
        kc._finish_build("radix", proc, d)
    print(json.dumps({"ptxas": {
        v: kc.ptxas_usage(kc.BUILD_LOGS.get(kc.build_label("radix", d),
                                            "")).get("plan_kernel")
        for v, d in defines.items()}}))
    libs = {v: kc.library("radix", rs._SIGNATURES, d)
            for v, d in defines.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for P, b, n in PLAN_SHAPES:
        dest = torch.from_numpy(
            rng.integers(0, P + 1, (b, n)).astype(np.int32)).to(dev)
        want = rs._radix_plan_plain(dest, P + 1)
        ms = in_turns(torch, cs, VARIANTS, lambda v: cs.plan_call(
            torch, kc, libs[v], dest, P + 1), want)
        b_ms, _ = cs.bound(8 * b * n + 4 * b * (P + 1), 12 * b * n)
        print(json.dumps({"plan": {"P": P, "shape": [b, n],
                                   "bound_ms": b_ms, "ms": ms}}))
    for n in SORT_NS:
        k1, k2 = (torch.from_numpy(
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(dev) for _ in range(2))
        want = rs._radix_sort_plain(k1, k2)
        # variant_sort loads the build of these defines: the patched one
        ms = in_turns(torch, cs, ("real", "ballot"), lambda v: cs.variant_sort(
            torch, kc, rs, defines[v], k1, k2), want)
        print(json.dumps({"sort": {"n": n, "ms": ms}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
