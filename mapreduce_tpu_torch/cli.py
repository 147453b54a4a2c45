"""Command line of the port — the reference's L5 layer (execute_server.lua,
SURVEY.md §1) for the WordCount example (port of ``mapreduce_tpu/cli.py``'s
``wordcount``):

  python -m mapreduce_tpu_torch.cli wordcount FILES... [--device]
      [--workers N] [--num-reducers N] [--sort-impl IMPL]
      [--partitions N] [--torch-device {cuda,cpu}] [-v]

Without ``--device`` the host plane runs: a server on an in-process board
and ``--workers`` worker threads run the map and reduce jobs.  With
``--device`` the same server hands the fused map, shuffle and reduce to
the port's engine over ``--partitions`` partitions on the card (the JAX
mesh's ``data`` axis); ``--torch-device cpu`` runs the engine's plain
PyTorch versions instead, and without CUDA the default raises rather
than falling back.  Stdout holds ``count word`` lines sorted by
``(-count, word)``, as the JAX CLI prints them; the run summary (the
stats doc, read off the metrics registry, and the storage bytes the run
moved) goes to stderr.

Not offered yet: ``--autotune`` and ``--speculative-reclaim`` (ROADMAP
A.7), and the ``server`` / ``worker`` / ``drop`` commands, which go with
the networked board (ROADMAP A.4b).
"""

from __future__ import annotations

import argparse
import logging
import sys
import uuid
from typing import List, Optional

SORT_IMPLS = ("variadic", "argsort", "radix", "tiered", "tiered-radix")


def _setup_logging(verbose: int) -> None:
    level = (logging.WARNING, logging.INFO, logging.DEBUG)[min(verbose, 2)]
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        stream=sys.stderr)


def cmd_wordcount(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch wordcount")
    p.add_argument("files", nargs="+")
    p.add_argument("--device", action="store_true",
                   help="run the fused map+shuffle+reduce on the port's "
                        "device engine instead of the host job-board path")
    p.add_argument("--workers", type=int, default=4,
                   help="worker threads of the host plane")
    p.add_argument("--num-reducers", type=int, default=15)
    p.add_argument("--sort-impl", choices=SORT_IMPLS, default=None,
                   help="device-engine sort: 'radix' runs every sort and "
                        "the exchange plan on the radix kernels; "
                        "'tiered' / 'tiered-radix' serve a cold start on "
                        "'argsort' until the steady tier's kernels are "
                        "built; default is the module's config "
                        "(variadic)")
    p.add_argument("--partitions", type=int, default=1,
                   help="device-engine partitions on the one card (the "
                        "JAX mesh's data axis)")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where the device engine runs; 'cpu' runs each "
                        "kernel's plain PyTorch version")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v info, -vv debug")
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    from .server import Server

    connstr = f"mem://{uuid.uuid4().hex}"
    m = "mapreduce_tpu_torch.examples.wordcount"
    params = {r: m for r in ("taskfn", "mapfn", "partitionfn",
                             "reducefn", "finalfn")}
    params["combinerfn"] = m
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    params["init_args"] = {"files": args.files,
                           "num_reducers": args.num_reducers}
    threads = []
    if args.device:
        from .parallel.mesh import Partitions

        params["device"] = True
        params["partitions"] = Partitions(args.partitions,
                                          args.torch_device)
        if args.sort_impl:
            params["init_args"]["device_sort_impl"] = args.sort_impl
    else:
        if (args.sort_impl or args.partitions != 1
                or args.torch_device != "cuda"):
            print("WARNING: --sort-impl/--partitions/--torch-device only "
                  "affect the device engine (--device); the host path "
                  "ignores them", file=sys.stderr)
        from .worker import spawn_worker_threads

        threads = spawn_worker_threads(connstr, "wc", args.workers)
    from .obs.metrics import REGISTRY

    def storage_bytes(direction):
        return REGISTRY.sum("mrtpu_storage_bytes_total", direction=direction)

    server = Server(connstr, "wc")
    server.configure(params)
    # the summary's storage bytes are this run's: deltas around the loop
    before = {d: storage_bytes(d) for d in ("write", "read")}
    stats = server.loop()
    moved = {d: storage_bytes(d) - before[d] for d in before}
    wedged = []
    for t in threads:
        t.join(timeout=30)
        if t.is_alive():
            wedged.append(t.name)
    from .examples.wordcount import RESULT
    counts = dict(RESULT)
    for word in sorted(counts, key=lambda w: (-counts[w], w)):
        print(counts[word], word)
    # run summary from the stats doc, which the server reads off the
    # metrics registry
    def written(phase):  # "count" holds WRITTEN plus FAILED terminals
        return stats[phase]["count"] - stats[phase]["failed"]

    line = ("run: {} map + {} reduce jobs written | storage {:.0f} B "
            "written, {:.0f} B read".format(
                written("map"), written("reduce"), moved["write"],
                moved["read"]))
    if args.device:
        dev = stats["device"]
        line += (" | device: {} waves, {} retries, compute {:.4f} s, "
                 "prepare {:.4f} s, result {:.4f} s".format(
                     dev["waves"], dev["retries"], dev["compute_s"],
                     dev["prepare_s"], dev["result_s"]))
    print(line, file=sys.stderr)
    if wedged:
        print(f"ERROR: {len(wedged)} worker thread(s) did not exit "
              f"within 30s: {', '.join(wedged)}", file=sys.stderr)
        return 1
    return 0


COMMANDS = {"wordcount": cmd_wordcount}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
