"""Command line of the port — the reference's L5 layer (execute_server.lua
/ execute_worker.lua, SURVEY.md §1; port of ``mapreduce_tpu/cli.py``):

  python -m mapreduce_tpu_torch.cli server CONNSTR DB TASKFN MAPFN
      PARTITIONFN REDUCEFN [FINALFN] [COMBINERFN] [STORAGE]
      [--init-args JSON] [--result-ns NS]
  python -m mapreduce_tpu_torch.cli worker CONNSTR DB [--workers N]
      [--max-iter N] [--max-sleep S] [--max-tasks N] [--claim-batch N]
      [--no-claim-ahead] [--name NAME]
  python -m mapreduce_tpu_torch.cli docserver [--host H] [--port N]
      [--root DIR | --ha-dir DIR [--ha-lease S] [--ha-fsync]]
      [--max-inflight N] [--tenant-max-queued-{tasks,jobs,bytes} N]
      [--slo SPEC]... [--history-dir DIR] [--history-keep N]
      [--history-segment-bytes B] [--history-max-age S]
      [--alert SPEC]... [--alert-rules FILE] [--alert-webhook
      [NAME=]HOST:PORT]... [--alert-exec [NAME=]CMD]...
      [--alert-interval S] [--alert-damp S] — the job board over HTTP
      (the mongod role), replicated with --ha-dir, hosting the
      multi-tenant scheduler's /tasks, the cluster snapshot /statusz,
      the durable telemetry history /queryz and the alerting plane
      /alertz
  python -m mapreduce_tpu_torch.cli status CONNSTR [--watch S] [--json]
      — the live cluster view (/statusz rendered)
  python -m mapreduce_tpu_torch.cli profile CONNSTR --out DIR — a
      profile bundle of /metrics, /statusz, /tracez and /clusterz
  python -m mapreduce_tpu_torch.cli diagnose CONNSTR|FILE [--json]
      [--skew-ratio R] — stragglers, skew, hotspots and the critical
      path of a live /clusterz or a saved cluster_trace.json
  python -m mapreduce_tpu_torch.cli history CONNSTR --metric FAMILY
      [--label K=V]... [--range S] [--step S]
      [--fn {raw,rate,increase,delta}] [--by-proc] [--follow
      [--interval S]] [--json] — a range query over /queryz
  python -m mapreduce_tpu_torch.cli top CONNSTR [--k N] [--window S]
      [--json] — the busiest counter series of the history
  python -m mapreduce_tpu_torch.cli alerts CONNSTR [--silence RULE
      [--duration S]] [--ack RULE] [--watch S] [--json] — the alerting
      plane's rules and instances (/alertz)
  python -m mapreduce_tpu_torch.cli submit CONNSTR TENANT TASKFN MAPFN
      PARTITIONFN REDUCEFN [FINALFN] [STORAGE] [--db DB] [--device]
      [--priority N] [--weight W] [--est-jobs N] [--est-bytes N]
      [--init-args JSON]
  python -m mapreduce_tpu_torch.cli tasks CONNSTR [--cancel ID] [--json]
  python -m mapreduce_tpu_torch.cli timeline CONNSTR --out FILE — the
      docserver's merged cluster timeline (/clusterz) as one
      Perfetto-loadable Chrome trace
  python -m mapreduce_tpu_torch.cli runner CONNSTR [--workers N]
      [--max-inflight N] [--job-lease S] [--partitions N]
      [--torch-device {cuda,cpu}] [--slo SPEC]... — the always-on
      serving process
  python -m mapreduce_tpu_torch.cli blobserver ROOT [--host H]
      [--port N] [--no-gzip] — the ``http:HOST:PORT`` blob service
  python -m mapreduce_tpu_torch.cli drop CONNSTR DB [--storage DSL]
  python -m mapreduce_tpu_torch.cli wordcount FILES... [--device]
      [--workers N] [--num-reducers N] [--sort-impl IMPL]
      [--partitions N] [--torch-device {cuda,cpu}]
  python -m mapreduce_tpu_torch.cli warmup [--compile-cache DIR]
      [--sort-impl IMPL | --tier {0,1,both}] [--bench] [--replay]
      [--torch-device {cuda,cpu}] [--json]
  python -m mapreduce_tpu_torch.cli train CONNSTR DBNAME [--storage DSL]
      [--epochs N] [--bunch N] [--patience N] [--seed N] [--keep N]
      [--lease S | --no-lease] [--acquire-timeout S] [--holder NAME]
      [--fresh] [--device {cuda,cpu}]

CONNSTR is ``mem://NAME`` (one process), ``dir:///PATH`` (a shared
directory: processes on one host or NFS) or ``http://[TOKEN@]HOST:PORT``
(a ``docserver`` of either package — any worker on any machine joins
over TCP, the reference's N-processes-one-mongod topology).  STORAGE is
``mem[:NAME]``, ``shared:PATH`` or ``http:HOST:PORT`` (a
``blobserver``).  ``server``, ``worker`` and ``train`` take ``--auth``
(else ``$MAPREDUCE_TPU_AUTH``), the retry flags of both network planes
and ``--telemetry-interval`` (pushes to an ``http://`` board's
collector); ``docserver``, ``blobserver`` and ``drop`` take ``--auth``;
every job command takes ``--trace-out FILE`` (this process's spans as
Chrome trace JSON at exit; it also arms the flight recorder, so a
SIGTERM dumps ``FILE.flight.trace.json`` and ``FILE.flight.metrics.prom``
and exits 143).  Every command takes ``-v``.

``wordcount``: without ``--device`` the host plane runs: a server on an
in-process board and ``--workers`` worker threads run the map and reduce
jobs.  With ``--device`` the same server hands the fused map, shuffle
and reduce to the port's engine over ``--partitions`` partitions on the
card (the JAX mesh's ``data`` axis); ``--torch-device cpu`` runs the
engine's plain PyTorch versions instead, and without CUDA the default
raises rather than falling back.  Stdout holds ``count word`` lines
sorted by ``(-count, word)``, as the JAX CLI prints them; the run
summary (the stats doc, read off the metrics registry, and the storage
bytes the run moved) goes to stderr.

``train`` is elastic, preemption-tolerant training of the digits MLP: a
trainer lease on the board so only one trainer advances the state and a
preempted one fences at its next epoch, manifest-committed checkpoints
on the storage plane with keep-N + best retention, and resume-on-restart
from the latest complete checkpoint (either package's).  Exit codes: 0
done (one JSON summary line on stdout), 2 the lease was not acquired
within ``--acquire-timeout``, 3 fenced (a successor holds the lease;
nothing is released).  Any other failure releases the lease before it
propagates.  ``--device`` picks the card (default) or the CPU; without
CUDA the default raises.

``submit``, ``tasks`` and ``runner`` are the always-on service: a
docserver (or an HA pair, ``http://H1:P1,H2:P2``) queues tenants' tasks
under their quotas, and the runner admits them weighted-fair and drives
each through the ``Server`` on this process's ``--partitions`` of the
card, with a pool of cross-tenant worker threads for the host plane.
``submit --device`` queues a device task; its sort travels in its
``--init-args`` (``device_sort_impl``).

The controllers (``engine/autotune``) are on by default for ``server``
and ``wordcount``, as in the JAX CLI: ``--autotune`` attaches the
capacity autotuner to the device phase's engine and
``--speculative-reclaim`` the straggler re-claim to the host plane's
poll loop (``--no-autotune`` / ``--no-speculative-reclaim`` turn them
off).  ``submit --program TOKEN`` names the program the runner's
admission advisor keys warmth on (e.g. ``wave``); the runner registers
its own placement facts with that advisor and refreshes them while it
serves.

``warmup`` builds every kernel library of the device engine's config
and the host core into the build directory and acquires the wave
program; ``--replay`` also precompiles every bucket of the shape
registry (``obs/compile``).  ``server``, ``worker``, ``wordcount``,
``train``, ``runner`` and ``warmup`` take ``--compile-cache [DIR]``
(default on: ``$MAPREDUCE_TPU_CACHE``, else ``build/kernels``, else the
user cache dir) and ``--no-compile-cache`` (a temporary build dir and
no registry; ``warmup`` then exits 1, as on a dir it cannot write).

``--slo NAME:pPCT:THRESHOLD[:LONG_S[:SHORT_S]]`` (repeatable, on
``docserver`` and ``runner``) replaces the serving objectives the
process's SLO plane evaluates (``obs/slo``): ``status`` renders them,
``diagnose`` names a breach.

``docserver --history-dir DIR`` (on ``<ha-dir>/history`` by default)
keeps every telemetry push as delta-encoded segments (``obs/history``):
``history`` and ``top`` query them, ``status`` shows the history row.
``--alert NAME:EXPR:OP:THRESHOLD[:FOR]`` (``increase|rate|delta(
FAMILY{k=v}[W])``, ``burn(OBJECTIVE)`` or ``anomaly(FAMILY[W])``) arms
the alerting plane (``obs/alerts``), evaluated every
``--alert-interval`` seconds on the primary and delivered exactly once
to each ``--alert-webhook`` / ``--alert-exec`` sink; ``alerts`` lists,
silences and acks its rules.

Every runner joins the board's engine-host fleet (``coord/fleet``);
``drain CONNSTR HOST`` flags one for drain, waits up to ``--timeout``
seconds for it to step down, and re-homes its routed streams to the best
live hosts.  ``status`` shows the fleet section.

Every JAX command is served: :data:`NOT_PORTED_COMMANDS` is empty.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import uuid
from typing import Dict, List, Optional

SORT_IMPLS = ("variadic", "argsort", "radix", "tiered", "tiered-radix")


def normalize_module(name: str) -> str:
    """execute_server.lua:37-39: path form -> module form."""
    if name.endswith(".py"):
        name = name[:-3]
    return name.replace("/", ".").strip(".")


def _add_verbosity(p: argparse.ArgumentParser) -> None:
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v info, -vv debug")


def _add_auth(p: argparse.ArgumentParser) -> None:
    p.add_argument("--auth", default=None, metavar="TOKEN",
                   help="shared-secret bearer token for the networked "
                        "planes (default: $MAPREDUCE_TPU_AUTH; can also "
                        "ride the connstr as http://TOKEN@HOST:PORT)")


def _add_retry(p: argparse.ArgumentParser) -> None:
    """Knobs for the networked planes' RetryPolicy (utils/httpclient.py);
    one flag set governs BOTH sockets — board RPCs and blob transfers.
    Defaults (when a flag is omitted) are RetryPolicy's."""
    g = p.add_argument_group("network retry / backoff / circuit breaker")
    g.add_argument("--retry-attempts", type=int, default=None,
                   metavar="N", help="max send attempts per call")
    g.add_argument("--retry-base-delay", type=float, default=None,
                   metavar="S", help="backoff scale for the first retry "
                   "(exponential with full jitter after that)")
    g.add_argument("--retry-max-delay", type=float, default=None,
                   metavar="S", help="cap on any single backoff sleep")
    g.add_argument("--retry-deadline", type=float, default=None,
                   metavar="S", help="whole-call wall-clock budget for "
                   "BOTH planes (unset: 12s board / 60s blob); keep "
                   "heartbeat_period + 2*deadline < job lease or healthy "
                   "workers get fenced")
    g.add_argument("--breaker-threshold", type=int, default=None,
                   metavar="N", help="consecutive transport failures that "
                   "open the circuit (fail fast); 0 disables")
    g.add_argument("--breaker-cooldown", type=float, default=None,
                   metavar="S", help="seconds the circuit stays open "
                   "before a half-open probe")


def _retry_policy(args):
    """Build a RetryPolicy from the _add_retry flags; None (= the module
    default) when every flag was left at its default."""
    overrides = {k: v for k, v in (
        ("max_attempts", args.retry_attempts),
        ("base_delay", args.retry_base_delay),
        ("max_delay", args.retry_max_delay),
        ("deadline", args.retry_deadline),
        ("breaker_threshold", args.breaker_threshold),
        ("breaker_cooldown", args.breaker_cooldown)) if v is not None}
    if not overrides:
        return None
    from .utils.httpclient import RetryPolicy

    return RetryPolicy(**overrides)


def _add_telemetry(p: argparse.ArgumentParser) -> None:
    p.add_argument("--telemetry-interval", type=float, default=1.0,
                   metavar="S",
                   help="seconds between telemetry pushes (spans + "
                        "metric snapshot) to the docserver's collector "
                        "over a dedicated socket (default 1.0; <= 0 "
                        "disables; http:// boards only)")


def _add_trace(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="on exit, write this process's spans as Chrome "
                        "trace-event JSON (load in Perfetto / "
                        "chrome://tracing).  The span buffer is a "
                        "bounded ring of --trace-max-events spans: "
                        "overflow evicts the OLDEST spans and counts "
                        "each eviction in mrtpu_trace_dropped_total")
    p.add_argument("--trace-max-events", type=int, default=None,
                   metavar="N",
                   help="span ring capacity (default: 100000)")


def _setup_trace(args):
    """Apply the ring bound BEFORE any span records.  With --trace-out
    set, also arm the flight recorder (obs/flight): SIGTERM and atexit
    dump the ring + registry to <trace-out>.flight.* paths, so a killed
    process keeps its telemetry.  Returns the recorder (or None)."""
    if args.trace_max_events:
        from .obs.trace import TRACER

        TRACER.max_events = max(1, args.trace_max_events)
    if args.trace_out:
        from .obs.flight import install_flight_recorder

        return install_flight_recorder(args.trace_out)
    return None


def _export_trace(args, recorder=None) -> None:
    if args.trace_out:
        from .obs.trace import TRACER

        print(f"trace written to {TRACER.export(args.trace_out)}",
              file=sys.stderr)
        if recorder is not None:
            # the normal export ran: flight files would be redundant
            # (their presence is the abnormal-exit signal)
            recorder.disarm()


def _add_controllers(p: argparse.ArgumentParser) -> None:
    """The job commands' controller switches, on by default as in the
    JAX CLI (library Servers default both off), and the compile-cache
    flags."""
    p.add_argument("--autotune", dest="autotune", action="store_true",
                   default=True,
                   help="capacity autotuning of the device phase's "
                        "engine (engine/autotune): pre-size capacities "
                        "from capacity-retry forensics; decisions land "
                        "in the control ledger (default ON)")
    p.add_argument("--no-autotune", dest="autotune",
                   action="store_false")
    p.add_argument("--speculative-reclaim", dest="reclaim",
                   action="store_true", default=True,
                   help="straggler-driven speculative re-claim of "
                        "host-plane jobs: a RUNNING job held far beyond "
                        "every other worker's completed-job profile is "
                        "re-claimed before its lease expires; "
                        "exactly-once rides the claim fencing (default "
                        "ON)")
    p.add_argument("--no-speculative-reclaim", dest="reclaim",
                   action="store_false")
    _add_compile_cache(p)


def _add_compile_cache(p: argparse.ArgumentParser) -> None:
    p.add_argument("--compile-cache", nargs="?", const=True, default=True,
                   metavar="DIR",
                   help="the build directory of the kernel libraries and "
                        "the shape registry (utils/compile_cache; default "
                        "on: $MAPREDUCE_TPU_CACHE, else the package-"
                        "adjacent build/kernels, else the user cache "
                        "dir; DIR picks another)")
    p.add_argument("--no-compile-cache", dest="compile_cache",
                   action="store_const", const=False,
                   help="build into a temporary directory of this "
                        "process (every build compiles; no registry)")


def _setup_compile_cache(args) -> str:
    """Point the builds (and the compile ledger's registry) where the
    flags say; returns the directory."""
    from .utils import compile_cache

    if args.compile_cache is False:
        path = compile_cache.disable_compile_cache()
    else:
        path = compile_cache.enable_compile_cache(
            None if args.compile_cache is True else args.compile_cache)
    logging.getLogger("mapreduce_tpu_torch.cli").info(
        "%s build dir at %s", "temporary" if args.compile_cache is False
        else "persistent", path)
    return path


def _attach_controllers(server, args) -> None:
    """``--speculative-reclaim`` and ``--autotune`` onto a Server (the
    autotuner without its skew controller: a batch run has no stream
    to rebalance)."""
    from .engine.autotune import AutoTuner, SpeculativeReclaimer

    if args.reclaim:
        server.reclaim = SpeculativeReclaimer()
    if args.autotune:
        server.autotune = AutoTuner(repartition=False)


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
    p.add_argument("--segment-impl", choices=("lax", "pallas"),
                   default=None,
                   help="the config's segmented-reduce formulation name "
                        "(kept for the config's identity, as the "
                        "wordcount example's device_segment_impl: on the "
                        "card the CUDA kernel runs whatever it says)")
    p.add_argument("--tokenize-impl", choices=("lax", "pallas"),
                   default=None,
                   help="the config's tokenizer formulation name; see "
                        "--segment-impl")
    p.add_argument("--partitions", type=int, default=1,
                   help="device-engine partitions on the one card (the "
                        "JAX mesh's data axis)")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where the device engine runs; 'cpu' runs each "
                        "kernel's plain PyTorch version")
    _add_controllers(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)
    rec = _setup_trace(args)
    _setup_compile_cache(args)

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
        if args.segment_impl:
            params["init_args"]["device_segment_impl"] = args.segment_impl
        if args.tokenize_impl:
            params["init_args"]["device_tokenize_impl"] = \
                args.tokenize_impl
    else:
        if args.sort_impl or args.segment_impl or args.tokenize_impl:
            print("WARNING: --sort-impl/--segment-impl/--tokenize-impl only "
                  "affect the device engine (--device); the host path "
                  "ignores them", file=sys.stderr)
        if args.partitions != 1 or args.torch_device != "cuda":
            print("WARNING: --partitions/--torch-device only affect the "
                  "device engine (--device); the host path ignores them",
                  file=sys.stderr)
        from .worker import spawn_worker_threads

        threads = spawn_worker_threads(connstr, "wc", args.workers)
    from .obs.metrics import REGISTRY

    def storage_bytes(direction):
        return REGISTRY.sum("mrtpu_storage_bytes_total", direction=direction)

    server = Server(connstr, "wc")
    _attach_controllers(server, args)
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
    _export_trace(args, rec)
    if wedged:
        print(f"ERROR: {len(wedged)} worker thread(s) did not exit "
              f"within 30s: {', '.join(wedged)}", file=sys.stderr)
        return 1
    return 0


def cmd_train(argv: List[str]) -> int:
    """Elastic, preemption-tolerant training of the digits MLP (the JAX
    CLI's ``train``): lease, per-epoch checkpoints, resume."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch train")
    p.add_argument("connstr", help="job board for the trainer lease "
                   "(mem://NAME, dir:///PATH or http://HOST:PORT)")
    p.add_argument("dbname")
    p.add_argument("--storage", default=None, metavar="DSL",
                   help="checkpoint blob plane (mem[:NAME] | "
                        "shared:PATH | http:HOST:PORT); default: "
                        "shared:./mrtpu_ckpt_<dbname>")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--bunch", type=int, default=32,
                   help="per-data-shard batch size")
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--keep", type=int, default=3, metavar="N",
                   help="checkpoint retention: newest N plus the best")
    p.add_argument("--lease", type=float, default=None, metavar="S",
                   help="trainer lease seconds (default 15; heartbeats "
                        "ride epoch boundaries, so keep this above one "
                        "epoch + one checkpoint write)")
    p.add_argument("--no-lease", action="store_true",
                   help="run without the single-writer lease")
    p.add_argument("--acquire-timeout", type=float, default=None,
                   metavar="S",
                   help="give up (exit 2) if the lease is not acquired in "
                        "S seconds (default: wait forever)")
    p.add_argument("--holder", default=None,
                   help="lease holder name (default: auto-generated)")
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing checkpoints (no resume)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the trainer runs; 'cpu' runs the plain "
                        "PyTorch path")
    _add_telemetry(p)
    _add_auth(p)
    _add_retry(p)
    _add_compile_cache(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    rec = _setup_trace(args)
    _setup_compile_cache(args)

    from . import storage as storage_mod
    from .coord import Connection, TrainerFencedError, TrainerLease
    from .coord.lease import DEFAULT_TRAINER_LEASE
    from .models import (
        DistributedTrainer, MLPConfig, TrainConfig, make_digits)
    from .models.checkpoint import CheckpointManager
    from .obs.collector import acquire_pusher, release_pusher

    storage_dsl = args.storage or f"shared:mrtpu_ckpt_{args.dbname}"
    retry = _retry_policy(args)
    cnn = Connection(args.connstr, args.dbname, auth=args.auth,
                     retry=retry)
    manager = CheckpointManager(
        storage_mod.router(storage_dsl, auth=cnn.auth_token(),
                           retry=retry),
        keep_n=args.keep)
    lease = None
    if not args.no_lease:
        lease = TrainerLease(cnn, holder=args.holder,
                             lease=args.lease or DEFAULT_TRAINER_LEASE)
        try:
            gen = lease.acquire(timeout=args.acquire_timeout)
        except TimeoutError as exc:
            print(str(exc), file=sys.stderr)
            return 2
        print(f"trainer lease acquired (holder {lease.holder}, "
              f"generation {gen})", file=sys.stderr, flush=True)
    # telemetry (http boards only): the lease and trainer counters live
    # in THIS process; pushing them puts them on the board's /metrics
    tele = acquire_pusher(
        cnn.board_hostport(), cnn.auth_token(),
        role=f"trainer:{lease.holder if lease else args.dbname}",
        interval=args.telemetry_interval)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        try:
            # setup runs INSIDE the release-on-crash scope: a device or
            # data failure after acquire hands the lease back like any
            # other crash
            cfg = TrainConfig(max_epochs=args.epochs,
                              bunch_size=args.bunch,
                              patience=args.patience, seed=args.seed)
            trainer = DistributedTrainer(MLPConfig(), cfg,
                                         device=args.device)
            x_tr, y_tr, x_va, y_va = make_digits(seed=args.seed)
            out = trainer.fit(x_tr, y_tr, x_va, y_va, log=log,
                              manager=manager, lease=lease,
                              resume=not args.fresh)
        except TrainerFencedError as exc:
            # fenced: a successor owns the lineage now.  Exit distinctly
            # (and WITHOUT releasing — we hold nothing)
            print(f"FENCED: {exc}", file=sys.stderr)
            _export_trace(args, rec)
            return 3
        except BaseException:
            # any OTHER failure (storage error, Ctrl-C) still holds the
            # lease: hand it off so a standby claims at once instead of
            # waiting out the expiry
            if lease is not None:
                try:
                    lease.release()
                except OSError:
                    pass  # board unreachable: the lease expires itself
            raise
        if lease is not None:
            try:
                lease.release()
            except OSError:
                pass  # a finished run stays finished; the lease expires
        print(json.dumps({
            "epochs_run": out["epochs_run"],
            "start_epoch": out["start_epoch"],
            "restored": out["restored"], "best_epoch": out["best_epoch"],
            "best_val_loss": out["best_val_loss"],
            "checkpoints": manager.steps(), "best": manager.best_step(),
            "storage": storage_dsl}, default=float))
        _export_trace(args, rec)
        return 0
    finally:
        # final flush: the closing metric snapshot reaches the collector
        # on every exit path
        release_pusher(tele)


def cmd_server(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch server")
    p.add_argument("connstr",
                   help="job board connstr (mem://NAME, dir:///PATH, "
                        "http://HOST:PORT)")
    p.add_argument("dbname")
    p.add_argument("taskfn")
    p.add_argument("mapfn")
    p.add_argument("partitionfn")
    p.add_argument("reducefn")
    p.add_argument("finalfn", nargs="?", default=None)
    p.add_argument("combinerfn", nargs="?", default=None)
    p.add_argument("storage", nargs="?", default=None)
    p.add_argument("--init-args", default=None,
                   help="JSON passed to every module init()")
    p.add_argument("--result-ns", default=None)
    _add_telemetry(p)
    _add_controllers(p)
    _add_auth(p)
    _add_retry(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    rec = _setup_trace(args)
    _setup_compile_cache(args)

    from .server import Server

    params = {
        "taskfn": normalize_module(args.taskfn),
        "mapfn": normalize_module(args.mapfn),
        "partitionfn": normalize_module(args.partitionfn),
        "reducefn": normalize_module(args.reducefn),
        # the reference CLI defaults finalfn to an empty module; the
        # JAX CLI defaults it to the reducefn module (single-module form)
        "finalfn": normalize_module(args.finalfn or args.reducefn),
        "storage": args.storage,
    }
    if args.combinerfn:
        params["combinerfn"] = normalize_module(args.combinerfn)
    if args.init_args:
        params["init_args"] = json.loads(args.init_args)
    if args.result_ns:
        params["result_ns"] = args.result_ns
    server = Server(args.connstr, args.dbname, auth=args.auth,
                    retry=_retry_policy(args))
    _attach_controllers(server, args)
    server.telemetry_interval = args.telemetry_interval
    server.configure(params)
    stats = server.loop()
    print(json.dumps(stats, default=float))
    _export_trace(args, rec)
    return 0


def cmd_worker(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch worker")
    p.add_argument("connstr",
                   help="job board connstr (mem://NAME, dir:///PATH, "
                        "http://HOST:PORT)")
    p.add_argument("dbname")
    p.add_argument("--workers", type=int, default=1,
                   help="worker threads in this process")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--max-sleep", type=float, default=None)
    p.add_argument("--max-tasks", type=int, default=None)
    p.add_argument("--claim-batch", type=int, default=None, metavar="N",
                   help="jobs claimed per board round trip (claim "
                        "pipelining; 1 = the serial claim-per-job path)")
    p.add_argument("--no-claim-ahead", action="store_true",
                   help="do not overlap the next batch's claim RPC with "
                        "the current job's execution")
    p.add_argument("--name", default=None,
                   help="worker name (metric/trace label; with "
                        "--workers N > 1 each thread gets NAME-i). "
                        "Default: an auto-generated host-unique name")
    _add_telemetry(p)
    _add_auth(p)
    _add_retry(p)
    _add_compile_cache(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    rec = _setup_trace(args)
    _setup_compile_cache(args)

    from .worker import Worker, spawn_worker_threads

    conf = {k: v for k, v in (("max_iter", args.max_iter),
                              ("max_sleep", args.max_sleep),
                              ("max_tasks", args.max_tasks),
                              ("claim_batch", args.claim_batch),
                              ("telemetry_interval",
                               args.telemetry_interval))
            if v is not None}
    if args.no_claim_ahead:
        conf["claim_ahead"] = False
    retry = _retry_policy(args)
    if args.workers == 1:
        w = Worker(args.connstr, args.dbname, auth=args.auth,
                   name=args.name, retry=retry)
        w.configure(conf)
        w.execute()
    else:
        threads = spawn_worker_threads(args.connstr, args.dbname,
                                       args.workers, conf=conf,
                                       auth=args.auth, retry=retry,
                                       name_prefix=args.name)
        for t in threads:
            t.join()
    _export_trace(args, rec)
    return 0


def cmd_blobserver(argv: List[str]) -> int:
    """Serve a directory as the ``http:HOST:PORT`` storage backend — the
    central blob service workers on other hosts point their storage DSL
    at (the cross-host role of the reference's sshfs backend,
    fs.lua:141-181)."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch blobserver")
    p.add_argument("root", help="directory to store blobs in")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8750,
                   help="0 binds a free port (printed)")
    p.add_argument("--no-gzip", action="store_true",
                   help="serve identity-only (no gzip negotiation); "
                        "clients fall back automatically")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)

    from .storage import BlobServer

    srv = BlobServer(args.root, args.host, args.port,
                     auth_token=args.auth,
                     gzip_enabled=not args.no_gzip)
    print(f"serving {args.root} at http:{srv.address} "
          f"(storage DSL: \"http:HOST:{srv.port}\")", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _add_slo(p) -> None:
    p.add_argument(
        "--slo", action="append", default=None, metavar="SPEC",
        help="serving-SLO objective NAME:pPCT:THRESHOLD[:LONG_S"
             "[:SHORT_S]] (repeatable; replaces the defaults).  NAME is "
             "one of submit_first_result / snapshot_staleness / "
             "queue_wait; e.g. --slo snapshot_staleness:p99:1.0:600:60")


def _setup_slo(args) -> None:
    """Apply the --slo flags to the process-global SLO plane (obs/slo);
    no flags = keep the documented defaults."""
    if not args.slo:
        return
    from .obs import slo as slo_mod

    slo_mod.configure([slo_mod.parse_objective(s) for s in args.slo])


def cmd_docserver(argv: List[str]) -> int:
    """Serve the control plane (job board) over HTTP — the mongod role.
    Workers and servers on any machine connect with ``http://HOST:PORT``
    as their CONNSTR; pass --root to back the board with a durable
    dir:// store that survives docserver restarts."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch docserver")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8751,
                   help="0 binds a free port (printed)")
    p.add_argument("--root", default=None,
                   help="back the board with dir://ROOT (durable) "
                        "instead of in-memory")
    h = p.add_argument_group(
        "high availability (coord/ha.py: run N replicas over ONE "
        "shared --ha-dir; the lease holder serves, the rest tail the "
        "mutation log and answer 421 so clients with a multi-endpoint "
        "connstr http://H1:P1,H2:P2 fail over; one replica over an "
        "--ha-dir is simply a durable board)")
    h.add_argument("--ha-dir", default=None,
                   help="shared directory holding the board mutation "
                        "log + primary lease (mutually exclusive with "
                        "--root)")
    h.add_argument("--ha-lease", type=float, default=None, metavar="S",
                   help="board-primary lease period (default 2.0s — "
                        "the failover detection window)")
    h.add_argument("--ha-fsync", action="store_true",
                   help="fsync every log append (survives host/power "
                        "death, not just process death; slower)")
    g = p.add_argument_group(
        "scheduler admission (the /tasks surface this board hosts; "
        "match --max-inflight on the runner — submits are quota-"
        "checked HERE, admission by whichever process holds the lease)")
    g.add_argument("--max-inflight", type=int, default=None,
                   help="tasks admitted+running at once (default 2)")
    g.add_argument("--tenant-max-queued-tasks", type=int, default=None)
    g.add_argument("--tenant-max-queued-jobs", type=int, default=None)
    g.add_argument("--tenant-max-queued-bytes", type=int, default=None)
    th = p.add_argument_group(
        "telemetry history (obs/history.py: every collector push "
        "appends delta-encoded samples to seq-stamped JSONL segments; "
        "/queryz + `cli history`/`cli top` read them back; defaults "
        "onto <ha-dir>/history under HA so a promoted standby keeps "
        "serving the series)")
    th.add_argument("--history-dir", default=None,
                    help="segment directory for the durable metric "
                         "history (implied under --ha-dir; omit both "
                         "to disable history)")
    th.add_argument("--history-keep", type=int, default=None,
                    metavar="N",
                    help="segments retained after rotation (default 8)")
    th.add_argument("--history-segment-bytes", type=int, default=None,
                    metavar="B",
                    help="rotate the active segment past this size "
                         "(default 1000000)")
    th.add_argument("--history-max-age", type=float, default=None,
                    metavar="S",
                    help="rotate the active segment past this age "
                         "(default 300s)")
    al = p.add_argument_group(
        "alerting (obs/alerts.py: rules evaluated on this board, every "
        "lifecycle transition appended to a generation-fenced log on "
        "the HA dir so a promoted standby resumes pending timers and "
        "never double-fires; read back at /alertz + `cli alerts`)")
    al.add_argument("--alert", action="append", default=None,
                    metavar="SPEC",
                    help="alert rule NAME:EXPR:OP:THRESHOLD[:FOR_S] "
                         "(repeatable).  EXPR is rate|increase|delta("
                         "FAMILY{k=v,...}[WINDOW_S]), burn(OBJECTIVE"
                         "[,short|long]) or anomaly(FAMILY{...}"
                         "[WINDOW_S]); e.g. --alert lost:increase("
                         "mrtpu_worker_lease_lost_total[300]):gt:0:60")
    al.add_argument("--alert-rules", default=None, metavar="FILE",
                    help="JSON file of rule specs (array of strings, "
                         "or {\"rules\": [...]})")
    al.add_argument("--alert-webhook", action="append", default=None,
                    metavar="[NAME=]HOST:PORT",
                    help="POST firing/resolved notifications here "
                         "(repeatable; NAME keys the durable delivery "
                         "cursor)")
    al.add_argument("--alert-exec", action="append", default=None,
                    metavar="[NAME=]CMD",
                    help="run CMD per notification, JSON on stdin "
                         "(repeatable)")
    al.add_argument("--alert-interval", type=float, default=5.0,
                    metavar="S",
                    help="evaluation sweep period (default 5s)")
    al.add_argument("--alert-damp", type=float, default=None,
                    metavar="S",
                    help="a firing rule resolves only after its "
                         "condition stays clear this long (default "
                         "30s)")
    _add_slo(p)
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    _setup_slo(args)

    from .coord.docserver import DocServer
    from .coord.docstore import DirDocStore
    from .sched.scheduler import SchedulerConfig

    overrides = {k: v for k, v in (
        ("max_inflight", args.max_inflight),
        ("tenant_max_queued_tasks", args.tenant_max_queued_tasks),
        ("tenant_max_queued_jobs", args.tenant_max_queued_jobs),
        ("tenant_max_queued_bytes", args.tenant_max_queued_bytes),
    ) if v is not None}
    if args.root and args.ha_dir:
        print("--root and --ha-dir are mutually exclusive (the HA "
              "board's durable state IS the mutation log)",
              file=sys.stderr)
        return 2
    store = DirDocStore(args.root) if args.root else None
    srv = DocServer(store, args.host, args.port, auth_token=args.auth,
                    scheduler_config=(SchedulerConfig(**overrides)
                                      if overrides else None),
                    ha_dir=args.ha_dir, ha_lease=args.ha_lease,
                    ha_fsync=args.ha_fsync,
                    history_dir=args.history_dir,
                    history_keep=args.history_keep,
                    history_segment_bytes=args.history_segment_bytes,
                    history_max_age_s=args.history_max_age,
                    alert_rules=args.alert,
                    alert_rules_file=args.alert_rules,
                    alert_webhooks=args.alert_webhook,
                    alert_execs=args.alert_exec,
                    alert_interval=args.alert_interval,
                    alert_damp=args.alert_damp)
    role = f"; HA role: {srv.ha.role}" if srv.ha is not None else ""
    hist = (f", durable history at /queryz ({srv.history.dir})"
            if srv.history is not None else "")
    if srv.alerts is not None:
        hist += ", alerting at /alertz ({} rule(s))".format(
            len(srv.alerts.rules))
    print(f"job board at http://{srv.host}:{srv.port} "
          f"(CONNSTR: \"http://HOST:{srv.port}\"; Prometheus at "
          f"/metrics, cluster snapshot at /statusz, merged cluster "
          f"timeline at /clusterz, scheduler at /tasks{hist}{role})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if srv.ha is not None:
            srv.ha.stop()  # a clean exit hands the board lease over
    return 0


def cmd_drop(argv: List[str]) -> int:
    """Drop a task's control-plane collections and (optionally) its
    storage blobs — the reference's remove_results.sh (db.dropDatabase())."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch drop")
    p.add_argument("connstr")
    p.add_argument("dbname")
    p.add_argument("--storage", default=None,
                   help="also clear this storage backend")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)

    from .coord import docstore

    store = docstore.connect(args.connstr, auth=args.auth)
    dropped = 0
    for coll in store.collections():
        if coll == args.dbname or coll.startswith(args.dbname + "."):
            store.drop_collection(coll)
            dropped += 1
    print(f"dropped {dropped} collections under {args.dbname!r}")
    if args.storage:
        from . import storage as storage_mod

        st = storage_mod.router(args.storage, auth=args.auth)
        n = len(st.list())
        st.clear()
        print(f"cleared {n} blobs from {args.storage!r}")
    return 0


def _sched_client(connstr: str, auth, what: str):
    """HOST:PORT normalisation + SchedulerClient construction for the
    /tasks commands."""
    from .sched.scheduler import SchedulerClient

    addr = connstr
    if addr.startswith("http://"):
        addr = addr[len("http://"):]
    addr = addr.split("/", 1)[0]
    try:
        return SchedulerClient(addr, auth_token=auth)
    except ValueError:
        print(f"{what} wants a docserver address (http://HOST:PORT), "
              f"got {connstr!r}", file=sys.stderr)
        return None


def _render_sched(sched: dict) -> List[str]:
    """The scheduler snapshot of GET /tasks: queue depth + declared
    queued work + served records per tenant, the in-flight count
    against the admission budget, the lease holder."""
    if not sched or not sched.get("tenants"):
        return []
    cfg = sched.get("config") or {}
    lines = ["scheduler: {} in-flight of {} max".format(
        sched.get("inflight", 0), cfg.get("max_inflight", "?"))]
    lease = sched.get("lease")
    if lease and lease.get("holder"):
        lines[0] += "  (admission lease: {} gen {})".format(
            lease["holder"], lease.get("generation", 0))
    for t, row in sorted(sched["tenants"].items()):
        active = " ".join(
            f"{s}={row.get(s, 0)}"
            for s in ("queued", "admitted", "running", "done",
                      "cancelled", "failed") if row.get(s))
        age = row.get("oldest_queued_age_s")
        lines.append(
            "  tenant {}: {}  | queued work {} jobs / {} B | "
            "{} records served{}".format(
                t, active or "idle", row.get("queued_jobs", 0),
                row.get("queued_bytes", 0),
                row.get("served_records", 0),
                "" if age is None
                else f" | oldest queued {age:.1f}s"))
    return lines


def cmd_submit(argv: List[str]) -> int:
    """Submit one task to a docserver's multi-tenant scheduler
    (``/tasks``, sched/scheduler.py): the task queues under the
    tenant's quota, the lease-holding runner admits it weighted-fair
    and drives it through the ordinary Server machinery.  Module
    arguments mirror ``cli server`` — they are stored in the task doc
    and resolved by the runner process.  Exit codes: 0 queued (the task
    doc as one JSON line), 3 rejected by a quota, 2 auth or address, 1
    board unreachable."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch submit")
    p.add_argument("connstr", help="the docserver, http://HOST:PORT "
                   "(or the HA pair http://H1:P1,H2:P2)")
    p.add_argument("tenant")
    p.add_argument("taskfn")
    p.add_argument("mapfn")
    p.add_argument("partitionfn")
    p.add_argument("reducefn")
    p.add_argument("finalfn", nargs="?", default=None)
    p.add_argument("storage", nargs="?", default=None)
    p.add_argument("--db", default=None,
                   help="task database on the board (default: "
                        "auto-generated; an ACTIVE db is refused — one "
                        "Server per db)")
    p.add_argument("--device", action="store_true",
                   help="run the task's fused map+shuffle+reduce on the "
                        "runner's device engine (the module's device "
                        "hooks); its sort is init-args' "
                        "device_sort_impl")
    p.add_argument("--priority", type=int, default=0,
                   help="within-tenant dequeue priority (higher first)")
    p.add_argument("--weight", type=float, default=1.0,
                   help="tenant fair-share weight")
    p.add_argument("--est-jobs", type=int, default=0,
                   help="declared job count (quota + fair-share charge)")
    p.add_argument("--est-bytes", type=int, default=0,
                   help="declared input bytes (quota accounting)")
    p.add_argument("--init-args", default=None,
                   help="JSON passed to every module init()")
    p.add_argument("--program", default=None,
                   help="program token this task's device phase "
                        "dispatches (e.g. wave): the runner's admission "
                        "advisor routes it to a placement where serving "
                        "it needs no kernel build; without it the task "
                        "kind is the key, which matches no token, and "
                        "warmth routing is inert")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    params = {
        "taskfn": normalize_module(args.taskfn),
        "mapfn": normalize_module(args.mapfn),
        "partitionfn": normalize_module(args.partitionfn),
        "reducefn": normalize_module(args.reducefn),
        "finalfn": normalize_module(args.finalfn or args.reducefn),
        "storage": args.storage,
    }
    if args.device:
        params["device"] = True
    if args.init_args:
        params["init_args"] = json.loads(args.init_args)
    if args.program:
        params["program"] = args.program
    client = _sched_client(args.connstr, args.auth, "submit")
    if client is None:
        return 2
    from .sched.scheduler import QuotaExceededError

    try:
        doc = client.submit(args.tenant, db=args.db, params=params,
                            priority=args.priority, weight=args.weight,
                            est_jobs=args.est_jobs,
                            est_bytes=args.est_bytes)
    except QuotaExceededError as exc:
        print(f"REJECTED ({exc.reason}): {exc}", file=sys.stderr)
        return 3
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(json.dumps(doc, default=float))
    return 0


def cmd_tasks(argv: List[str]) -> int:
    """List the scheduler's tasks and tenant queues (GET /tasks) or
    cancel one (``--cancel ID``: a cancelled task's queued jobs never
    run — its db is forced FINISHED and claimable jobs are removed)."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch tasks")
    p.add_argument("connstr", help="the docserver, http://HOST:PORT "
                   "(or the HA pair http://H1:P1,H2:P2)")
    p.add_argument("--cancel", default=None, metavar="TASK_ID")
    p.add_argument("--json", action="store_true", dest="as_json")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    client = _sched_client(args.connstr, args.auth, "tasks")
    if client is None:
        return 2
    try:
        if args.cancel:
            doc = client.cancel(args.cancel)
            if doc is None:
                print(f"task {args.cancel!r} not found or already "
                      "terminal", file=sys.stderr)
                return 1
            print(json.dumps(doc, default=float))
            return 0
        listing = client.list()
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        client.close()
    if args.as_json:
        print(json.dumps(listing, indent=2, default=float))
        return 0
    for line in _render_sched(listing.get("sched") or {}):
        print(line)
    for t in listing.get("tasks") or []:
        print("  {:<9} {}  tenant={} db={} prio={} est_jobs={}".format(
            t.get("state"), t.get("_id"), t.get("tenant"), t.get("db"),
            t.get("priority", 0), t.get("est_jobs", 0)))
    if not listing.get("tasks"):
        print("no tasks submitted to this scheduler")
    return 0


def _docserver_client(connstr: str, auth, what: str):
    """HOST:PORT normalisation + HttpDocStore construction for the
    exposition-plane commands (accepts pasted browser URLs)."""
    from .coord.docserver import HttpDocStore

    addr = connstr
    if addr.startswith("http://"):
        addr = addr[len("http://"):]
    addr = addr.split("/", 1)[0]
    try:
        return HttpDocStore(addr, auth_token=auth)
    except ValueError:
        print(f"{what} wants a docserver address (http://HOST:PORT), "
              f"got {connstr!r}: mem:// and dir:// boards live inside "
              "their owning process and have no wire to poll",
              file=sys.stderr)
        return None


def _render_device(dev: dict) -> List[str]:
    """The device-plane section of a /statusz snapshot (zero when the
    serving process never ran the engine — the engine's numbers live in
    the server/bench process, README scope caveat)."""
    if not dev or not (dev.get("flops_total") or dev.get("waves")):
        return []
    secs = dev.get("seconds", {})
    lines = ["device plane ({} waves, {} retries):".format(
        dev.get("waves", 0), dev.get("retries", 0))]
    lines.append(
        "  upload {:.2f}s  compute {:.2f}s  readback {:.2f}s | "
        "{:.3g} GFLOP, {:.3g} GB accessed".format(
            secs.get("upload", 0.0), secs.get("compute", 0.0),
            secs.get("readback", 0.0),
            dev.get("flops_total", 0.0) / 1e9,
            dev.get("bytes_total", 0.0) / 1e9))
    if dev.get("mfu"):
        lines.append(
            "  MFU {:.4%}  roofline {:.2%}  ({:.3g} FLOP/s achieved, "
            "{:.2f} flops/byte)".format(
                dev.get("mfu", 0.0), dev.get("roofline_frac", 0.0),
                dev.get("model_flops_per_s", 0.0),
                dev.get("arith_intensity", 0.0)))
    return lines


def _render_compile(comp: dict) -> List[str]:
    """The compile section of a /statusz snapshot (obs/compile ledger:
    per-program outcomes + build seconds + shape buckets); the JAX
    text's "in XLA" is "building" here (nvcc, g++, loads, captures)."""
    if not comp or not comp.get("programs"):
        return []
    lines = ["compile ledger ({} bucket(s), {:.1f}s building{}):".format(
        comp.get("buckets", 0), comp.get("total_compile_s", 0.0),
        "" if comp.get("cache_dir")
        else "; persistent cache DISABLED")]
    for prog, st in sorted(comp["programs"].items()):
        lines.append(
            "  {}: {} compiled / {} persistent-hit / {} cached, "
            "{:.2f}s (last {:.2f}s)".format(
                prog, st.get("compiled", 0), st.get("persistent_hit", 0),
                st.get("cached", 0), st.get("compile_s", 0.0),
                st.get("last_compile_s", 0.0)))
    return lines


def _render_memory(mem: dict) -> List[str]:
    """The memory section of a /statusz snapshot (obs/memory: live
    device bytes, per-program footprints, donation savings)."""
    if not mem:
        return []
    lines = ["device memory:"]
    devices = mem.get("devices") or {}
    if devices:
        src = mem.get("device_source", "measured")
        for dev, st in sorted(devices.items()):
            limit = st.get("bytes_limit")
            lines.append(
                "  device {}: {:.3g} B in use{}{} [{}]".format(
                    dev, float(st.get("bytes_in_use", 0)),
                    "" if st.get("peak_bytes_in_use") is None
                    else " (peak {:.3g})".format(
                        float(st["peak_bytes_in_use"])),
                    "" if not limit
                    else " of {:.3g}".format(float(limit)), src))
    for prog, m in sorted((mem.get("programs") or {}).items()):
        lines.append(
            "  program {}: {:.3g} B footprint (args {:.3g} + out "
            "{:.3g} + temp {:.3g}) [{}]".format(
                prog, float(m.get("total", 0)),
                float(m.get("arguments", 0)), float(m.get("outputs", 0)),
                float(m.get("temp", 0)), m.get("source", "?")))
    for prog, s in sorted((mem.get("donation") or {}).items()):
        lines.append(
            "  donation {}: {:.3g} B saved of {:.3g} donated [{}]".format(
                prog, float(s.get("bytes", 0)),
                float(s.get("donated_bytes", 0)),
                s.get("source", "?")))
    return lines


def _render_comms(comms: dict) -> List[str]:
    """The comms section of a /statusz snapshot (obs/comms: exchange
    traffic matrix roll-ups, link-class bytes, upload overlap)."""
    if not comms:
        return []
    lines = ["comms (exchange & dataflow):"]
    ex = comms.get("exchange") or {}
    if ex:
        lines.append(
            "  exchange: {} records / {:.3g} B over {} partition(s), "
            "imbalance send {:.2f}x / recv {:.2f}x (hot dst D{:03d} at "
            "{:.1%})".format(
                ex.get("records", 0), float(ex.get("bytes", 0)),
                ex.get("partitions", 0),
                ex.get("imbalance_send", 1.0),
                ex.get("imbalance_recv", 1.0),
                int(ex.get("hot_dst", 0)),
                ex.get("hot_dst_share", 0.0)))
        link = ex.get("bytes_by_link") or {}
        if link:
            lines.append("  bytes by link: " + "  ".join(
                f"{cls} {int(v):,}" for cls, v in sorted(link.items())))
        if ex.get("modeled_exchange_s") is not None:
            lines.append(
                "  modeled exchange {:.4g}s = {:.1%} of measured "
                "compute [analytic, peaks: {}]".format(
                    ex.get("modeled_exchange_s", 0.0),
                    ex.get("exchange_frac_of_compute", 0.0),
                    ex.get("peak_source", "?")))
    if comms.get("upload_overlap_frac") is not None:
        lines.append("  upload overlap: {:.1%} of upload waiting hid "
                     "under device execution".format(
                         comms["upload_overlap_frac"]))
    return lines


def _render_fleet(fleet: dict) -> List[str]:
    """The engine-fleet section of /statusz (coord/fleet): per-host
    membership state, lease headroom, heartbeat mesh facts, and how
    many streams route to each host."""
    if not fleet or not fleet.get("hosts"):
        return []
    lines = ["engine fleet: {} host(s), {} routed stream(s){}".format(
        len(fleet["hosts"]), fleet.get("routes", 0),
        ("  [{} routed at NO registered host]".format(
            fleet["routes_unhosted"])
         if fleet.get("routes_unhosted") else ""))]
    for host, h in sorted(fleet["hosts"].items()):
        frac = h.get("hbm_frac")
        state = str(h.get("state", "?"))
        # a left/expired host's lease stamp is history, not headroom
        lease = ("{:+.1f}s".format(h.get("lease_expires_in") or 0.0)
                 if state in ("live", "draining") else "-")
        lines.append(
            "  host {}: {}  gen {}  lease {}  "
            "{} stream(s)  {} warm program(s)  hbm {}".format(
                host, state.upper(), h.get("generation", 0), lease,
                h.get("streams", 0), h.get("warm_programs", 0),
                "-" if frac is None else f"{frac:.0%}"))
    return lines


def _render_slo(slo: dict) -> List[str]:
    """The serving-SLO section of /statusz (obs/slo): per-tenant
    objective percentiles, burn rates and breach state against the
    configured targets."""
    if not slo or not slo.get("tenants"):
        return []
    objectives = {o["name"]: o for o in slo.get("objectives") or []}
    lines = ["serving SLOs ({}):".format("  ".join(
        "{} {}<{:g}s/{:g}s+{:g}s".format(
            o["name"], o.get("pct", "p99"), o["threshold_s"],
            o["long_window_s"], o["short_window_s"])
        for o in (slo.get("objectives") or [])))]
    for tenant, objs in sorted(slo["tenants"].items()):
        for oname, e in sorted(objs.items()):
            pct = objectives.get(oname, {}).get("pct", "p99")
            p = e.get("p")
            lines.append(
                "  tenant {} {} {}: {} ({} obs, window {})  "
                "burn {:.1f}x/{:.1f}x  budget {:.0%}{}".format(
                    tenant, pct, oname,
                    "-" if p is None else f"{p:.4g}s",
                    e.get("n", 0), e.get("window_n", 0),
                    e.get("burn_short", 0.0), e.get("burn_long", 0.0),
                    e.get("budget_remaining", 1.0),
                    "  BREACHING" if e.get("breaching") else ""))
    return lines


def _render_control(ctrl: dict) -> List[str]:
    """The control section of /statusz (obs/control): the observe->act
    loop's decisions — per-controller outcome counts plus the newest
    decisions with their evidence->action->outcome story."""
    if not ctrl or not ctrl.get("decisions"):
        return []
    lines = ["control plane (observe->act):"]
    for c, by_o in sorted((ctrl.get("counts") or {}).items()):
        lines.append("  {}: {}".format(c, "  ".join(
            f"{o}={n}" for o, n in sorted(by_o.items()))))
    for d in ctrl["decisions"][-8:]:  # newest tail; bundles keep all
        lines.append(
            "  [{}] #{} task {} ({}, {:.0f}s ago): {}".format(
                d.get("controller"), d.get("id"), d.get("task"),
                d.get("outcome"), d.get("age_s", 0.0),
                d.get("note") or "decision"))
    return lines


def _render_build(build: dict) -> List[str]:
    """The identity line (obs/buildinfo): the port's build dict carries
    torch and CUDA where the JAX one carries jax."""
    if not build:
        return []
    return ["build: mrtpu {} | python {} | torch {} | cuda {} | backend "
            "{} ({})".format(
                build.get("version", "?"), build.get("python", "?"),
                build.get("torch", "?"), build.get("cuda", "?"),
                build.get("backend", "?"), build.get("device_kind", "?"))]


def _render_telemetry(tele: dict) -> List[str]:
    """The collector section of /statusz: per-task roll-ups plus push
    health per process."""
    if not tele:
        return []
    lines: List[str] = []
    tasks = tele.get("tasks") or {}
    for t, r in sorted(tasks.items()):
        lines.append(
            "  task {}: {:.0f} records, {:.0f} B, {:.3f} device s, "
            "{:.3g} FLOP".format(t, r.get("records", 0),
                                 r.get("bytes", 0),
                                 r.get("device_seconds", 0.0),
                                 r.get("flops", 0)))
    procs = tele.get("procs") or {}
    for proc, p in sorted(procs.items()):
        missed = p.get("missed") or 0
        lines.append(
            "  proc {} ({}): {} push(es), last {:.1f}s ago{}".format(
                proc, p.get("role", "?"), p.get("pushes", 0),
                p.get("last_push_age_s") or 0.0,
                f", {missed} spans LOST" if missed else ""))
    if lines:
        lines.insert(0, "telemetry (cluster roll-ups via collector):")
    return lines


def _render_history(hist: dict) -> List[str]:
    """The durable-history row of /statusz (obs/history): segment and
    series counts plus the covered wall-time span."""
    if not hist:
        return []
    if hist.get("error"):
        return [f"history: ERROR {hist['error']}"]
    span = ""
    oldest, newest = hist.get("oldest_t"), hist.get("newest_t")
    if oldest is not None and newest is not None:
        span = f", {newest - oldest:.0f}s span"
    gc = ""
    if hist.get("rotations") or hist.get("gc_segments"):
        gc = ", {} rotation(s) / {} gc'd".format(
            hist.get("rotations", 0), hist.get("gc_segments", 0))
    return ["history: {} segment(s), {} B, {} entr(ies), {} series "
            "from {} proc(s){}{} (keep {})".format(
                hist.get("segments", 0), hist.get("bytes", 0),
                hist.get("entries", 0), hist.get("series", 0),
                hist.get("procs", 0), span, gc,
                hist.get("keep_segments", "?"))]


def _render_alerts(al: dict) -> List[str]:
    """The alerts section of /statusz (obs/alerts): rule + instance
    lifecycle summary; firing instances are always listed."""
    if not al:
        return []
    counts = al.get("counts") or {}
    summary = ("  ".join(f"{s}={n}" for s, n in sorted(counts.items()))
               or "all inactive")
    log = al.get("log") or {}
    lines = ["alerts: {} rule(s), {} | log seq {} gen {}{}".format(
        len(al.get("rules") or []), summary,
        log.get("seq", 0), log.get("generation", 0),
        (", {} stale skipped".format(log["skipped_stale"])
         if log.get("skipped_stale") else ""))]
    for inst in al.get("instances") or []:
        if inst.get("state") not in ("firing", "pending"):
            continue
        lbl = ",".join(f"{k}={v}" for k, v in
                       sorted((inst.get("labels") or {}).items()))
        flags = ""
        if inst.get("suppressed"):
            flags += " [silenced]"
        if inst.get("acked"):
            flags += " [acked]"
        lines.append("  {} {}{}: {:.0f}s{}{}".format(
            inst["state"].upper(), inst.get("rule"),
            f"{{{lbl}}}" if lbl else "", inst.get("age_s") or 0.0,
            ("" if inst.get("value") is None
             else " (value {:.4g})".format(float(inst["value"]))),
            flags))
    for s in al.get("silences") or []:
        lines.append("  silence #{} on {}: {:.0f}s left".format(
            s.get("id"), s.get("rule"), s.get("expires_in_s") or 0.0))
    return lines


def _render_checkpoint(ck: dict) -> List[str]:
    """The training-plane section of /statusz: checkpoint save/restore/
    corruption counters and the last recovery time (obs/statusz
    checkpoint_snapshot)."""
    if not ck:
        return []
    line = ("checkpoints: {:.0f} saved (last step {:.0f}) | restores "
            "{:.0f} ok / {:.0f} corrupt ({:.0f} bad shards, {:.0f} "
            "fallbacks) | {:.0f} gc'd | {:.0f} fences".format(
                ck.get("saves", 0), ck.get("last_saved_step", 0),
                ck.get("restores_ok", 0), ck.get("restores_corrupt", 0),
                ck.get("corrupt_shards", 0), ck.get("fallbacks", 0),
                ck.get("gc", 0), ck.get("lease_fences", 0)))
    out = [line]
    if ck.get("recovery_s"):
        out.append("  last step-recovery: {:.3f}s".format(
            ck["recovery_s"]))
    return out


def _render_ha(ha: dict) -> List[str]:
    """The board-HA section of /statusz (coord/ha.py): role, fencing
    generation, mutation-log progress."""
    if not ha:
        return []
    lease = ha.get("lease") or {}
    out = ["board ha: {} (generation {}, holder {}) | log {} appended "
           "/ {} replayed / {}B (lag {}B) | {} promotion(s)".format(
               ha.get("role", "?"), ha.get("generation", 0),
               lease.get("holder") or ha.get("holder") or "-",
               ha.get("log_appended", 0), ha.get("log_replayed", 0),
               ha.get("log_bytes", 0), ha.get("replay_lag_bytes", 0),
               ha.get("promotions", 0))]
    if ha.get("failed"):
        out.append(f"  BOARD HA FAILED: {ha['failed']}")
    return out


def render_status(snap: dict) -> str:
    """One-screen text view of a /statusz snapshot (the master status
    page role, Dean & Ghemawat §4.6)."""
    lines: List[str] = _render_build(snap.get("build") or {})
    lines += _render_ha(snap.get("ha") or {})
    lines += _render_device(snap.get("device") or {})
    lines += _render_compile(snap.get("compile") or {})
    lines += _render_memory(snap.get("memory") or {})
    lines += _render_comms(snap.get("comms") or {})
    lines += _render_checkpoint(snap.get("checkpoint") or {})
    lines += _render_sched(snap.get("sched") or {})
    lines += _render_fleet(snap.get("fleet") or {})
    lines += _render_slo(snap.get("slo") or {})
    lines += _render_control(snap.get("control") or {})
    lines += _render_alerts(snap.get("alerts") or {})
    lines += _render_telemetry(snap.get("telemetry") or {})
    lines += _render_history(snap.get("history") or {})
    tasks = snap.get("tasks", {})
    if not tasks:
        lines.append("no tasks on this board")
        return "\n".join(lines) + "\n"
    for db, t in sorted(tasks.items()):
        lines.append(f"[{db}]  status={t.get('status')}  "
                     f"iteration={t.get('iteration')}"
                     + ("  (device plane)" if t.get("device") else ""))
        for phase in ("map", "reduce"):
            counts = t.get("phases", {}).get(phase) or {}
            total = sum(counts.values())
            if not total:
                lines.append(f"  {phase:<7}-")
                continue
            parts = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
            lines.append(f"  {phase:<7}{total} jobs: {parts}")
        tl = t.get("trainer")
        if tl:
            lines.append(
                "  trainer lease: {} (generation {}, {}, lease "
                "{:+.1f}s)".format(
                    tl.get("holder") or "FREE", tl.get("generation"),
                    "HELD" if tl.get("held") else "free/expired",
                    tl.get("lease_expires_in") or 0.0))
        workers = t.get("workers", {})
        if workers:
            for name, w in sorted(workers.items()):
                lease = w.get("lease_expires_in")
                liveness = ("ALIVE" if w.get("alive") else
                            "idle/done" if w.get("running", 0) == 0
                            else "STALE")
                lease_s = (f" lease {lease:+.1f}s" if lease is not None
                           else "")
                lines.append(
                    f"  worker {name}: {liveness}  "
                    f"{w.get('running', 0)} running / "
                    f"{w.get('jobs', 0)} held{lease_s}")
        else:
            lines.append("  workers: none seen")
        nerr = t.get("errors", 0)
        if nerr:
            lines.append(f"  ERRORS: {nerr} in the errors channel")
        stats = t.get("stats")
        if stats:
            m, r = stats.get("map", {}), stats.get("reduce", {})
            lines.append(
                "  last stats: map {}j/{}f cpu {:.2f}s | reduce {}j/{}f "
                "cpu {:.2f}s | cluster {:.2f}s (iter {})".format(
                    m.get("count", 0), m.get("failed", 0),
                    m.get("sum_cpu_time", 0.0),
                    r.get("count", 0), r.get("failed", 0),
                    r.get("sum_cpu_time", 0.0),
                    stats.get("cluster_time", 0.0),
                    stats.get("iteration", 0)))
            d = stats.get("device")
            if d:
                # per-task engine timings travel in the persisted stats
                # doc, so they render even when the statusz-serving
                # process is not the one that ran the engine
                mfu = ("  MFU {:.4%}".format(d["mfu"])
                       if d.get("mfu") else "")
                lines.append(
                    "  device: {} waves  upload {:.2f}s  compute "
                    "{:.2f}s  readback {:.2f}s{}".format(
                        d.get("waves", 0), d.get("upload_s", 0.0),
                        d.get("compute_s", 0.0),
                        d.get("readback_s", 0.0), mfu))
    return "\n".join(lines) + "\n"


def cmd_status(argv: List[str]) -> int:
    """Live cluster view: poll the docserver's /statusz and render it
    (the reference had only the end-of-run stats doc; this is the
    during-the-run window)."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch status")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT — or the HA "
                        "replica set http://H1:P1,H2:P2: the watcher "
                        "fails over with the board (the same CONNSTR "
                        "workers use)")
    p.add_argument("--watch", type=float, default=None, metavar="S",
                   help="re-poll every S seconds until interrupted "
                        "(default: render once and exit)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw /statusz JSON instead")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    store = _docserver_client(args.connstr, args.auth, "status")
    if store is None:
        return 2
    import time as _time

    try:
        while True:
            try:
                snap = store.statusz()
            except PermissionError as exc:
                # auth rejection never heals on its own: bail out even
                # in watch mode, with the real diagnosis
                print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
                      file=sys.stderr)
                return 2
            except OSError as exc:
                if args.watch is None:
                    print(f"cannot reach {args.connstr}: {exc}",
                          file=sys.stderr)
                    return 1
                # watch mode exists precisely for degraded clusters: a
                # transient poll failure is a line, not an exit
                print(f"[poll failed: {exc}]", file=sys.stderr)
            else:
                if args.as_json:
                    out = json.dumps(snap, indent=2, default=float)
                else:
                    out = render_status(snap)
                if args.watch is not None and not args.as_json:
                    # one-screen refresh: clear + home, like watch(1);
                    # --json is a stream for machines, never cleared
                    sys.stdout.write("\x1b[2J\x1b[H")
                sys.stdout.write(out)
                sys.stdout.flush()
                if args.watch is None:
                    return 0
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    finally:
        store.close()


def cmd_profile(argv: List[str]) -> int:
    """Capture a self-contained profile bundle from a LIVE cluster: the
    docserver's /metrics exposition, /statusz cluster snapshot, /tracez
    span ring and /clusterz merged timeline (with its diagnosis) land in
    one directory that ``obs.profile.load_bundle`` re-validates and
    Perfetto and Prometheus load directly."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch profile")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT "
                        "(the same CONNSTR workers use)")
    p.add_argument("--out", required=True, metavar="DIR",
                   help="bundle directory (created if missing)")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    from .obs import profile as obs_profile

    store = _docserver_client(args.connstr, args.auth, "profile")
    if store is None:
        return 2
    try:
        metrics_text = store.metrics_text()
        statusz_doc = store.statusz()
        trace_doc = store.tracez()
        cluster_doc = store.clusterz()
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        store.close()
    out = obs_profile.write_bundle(
        args.out, metrics_text=metrics_text, statusz_doc=statusz_doc,
        trace_doc=trace_doc, cluster_doc=cluster_doc)
    n_ev = len(trace_doc.get("traceEvents", []))
    print(f"profile bundle written to {out} ({n_ev} trace events); "
          f"open trace.json in https://ui.perfetto.dev")
    return 0


def cmd_diagnose(argv: List[str]) -> int:
    """Cluster diagnosis over the merged timeline: stragglers (robust
    outlier test on claim->write latency), skewed partitions (share vs
    uniform), retry/fault hotspots, and the claim/run/write phase
    breakdown (obs/analysis)."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch diagnose")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT — or a saved "
                        "timeline/cluster_trace.json file (offline "
                        "diagnosis)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the structured report as JSON")
    p.add_argument("--skew-ratio", type=float, default=None,
                   metavar="R",
                   help="flag partitions whose share exceeds R x the "
                        "uniform share (default 2.0)")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    from .obs import analysis

    if os.path.exists(args.connstr):
        with open(args.connstr, encoding="utf-8") as f:
            doc = json.load(f)
    else:
        store = _docserver_client(args.connstr, args.auth, "diagnose")
        if store is None:
            return 2
        try:
            doc = store.clusterz()
        except PermissionError as exc:
            print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
                  file=sys.stderr)
            return 2
        except OSError as exc:
            print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
            return 1
        finally:
            store.close()
    kw = ({"skew_ratio": args.skew_ratio}
          if args.skew_ratio is not None else {})
    report = analysis.diagnose(doc, **kw)
    if args.as_json:
        print(json.dumps(report, indent=2, default=float))
    else:
        sys.stdout.write(analysis.render_diagnosis(report))
    return 0


def cmd_history(argv: List[str]) -> int:
    """Range-query the docserver's durable telemetry history
    (/queryz): one metric family, optional label matchers, a trailing
    window, and a server-side fn (raw samples or aligned
    rate/increase/delta series)."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch history")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT")
    p.add_argument("--metric", required=True, metavar="FAMILY",
                   help="metric family, e.g. mrtpu_records_total")
    p.add_argument("--label", action="append", default=[],
                   metavar="K=V",
                   help="label matcher (repeatable), e.g. task=wc")
    p.add_argument("--range", type=float, default=600.0, dest="range_s",
                   metavar="S",
                   help="trailing window in seconds (default 600)")
    p.add_argument("--step", type=float, default=None, metavar="S",
                   help="step-align rate/increase/delta series to S "
                        "second buckets")
    p.add_argument("--fn", default="increase",
                   choices=("raw", "rate", "increase", "delta"),
                   help="server-side function (default increase)")
    p.add_argument("--by-proc", action="store_true", dest="by_proc",
                   help="split counter series per pushing process")
    p.add_argument("--follow", action="store_true",
                   help="tail mode: re-issue the range query every "
                        "--interval and print only new steps (watch a "
                        "series without a dashboard; ctrl-c exits)")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="--follow poll period (default 2s)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw /queryz response as JSON")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    if args.follow and args.interval <= 0:
        print("--interval must be > 0", file=sys.stderr)
        return 2
    for m in args.label:
        if "=" not in m:
            print(f"bad --label {m!r} (want K=V)", file=sys.stderr)
            return 2
    store = _docserver_client(args.connstr, args.auth, "history")
    if store is None:
        return 2
    params: dict = {"metric": args.metric, "fn": args.fn,
                    "start": -abs(args.range_s)}
    if args.label:
        params["match"] = list(args.label)
    if args.step is not None:
        params["step"] = args.step
    if args.by_proc:
        params["by_proc"] = 1
    try:
        try:
            doc = store.queryz(params)
        except PermissionError as exc:
            print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
                  file=sys.stderr)
            return 2
        except OSError as exc:
            print(f"cannot query {args.connstr}: {exc}",
                  file=sys.stderr)
            return 1
        if args.as_json and not args.follow:
            print(json.dumps(doc, indent=2, default=float))
            return 0
        series = doc.get("series") or []
        print(f"{doc.get('metric')} [{doc.get('kind')}] "
              f"fn={doc.get('fn')} "
              f"window {doc.get('start')}..{doc.get('end')}"
              + (f" step {doc.get('step')}s" if doc.get("step")
                 else ""))
        if not series and not args.follow:
            print("  (no samples in range — is the history plane "
                  "enabled on the docserver, and did anything push?)")
            return 0
        last_t = _print_history_points(series, float("-inf"))
        if not args.follow:
            return 0
        # tail mode: re-issue the same trailing-window query and print
        # only steps newer than anything already shown — `tail -f` for
        # a metric series
        import time as _time

        while True:
            try:
                _time.sleep(args.interval)
                doc = store.queryz(params)
            except KeyboardInterrupt:
                return 0
            except (OSError, ValueError) as exc:
                print(f"  [poll failed: {exc}]", file=sys.stderr)
                continue
            last_t = _print_history_points(doc.get("series") or [],
                                           last_t)
    except KeyboardInterrupt:
        return 0
    finally:
        store.close()


def _print_history_points(series: list, last_t: float) -> float:
    """Print every point newer than *last_t*, label-prefixed; return
    the new high-water timestamp (the --follow tail cursor)."""
    newest = last_t
    for s in series:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted(s["labels"].items()))
        pts = [(t, v) for t, v in (s.get("points") or [])
               if t > last_t]
        if not pts:
            continue
        print(f"  {{{labels}}}: {len(pts)} point(s)")
        for t, v in pts:
            print(f"    {t:.3f}  {v:g}", flush=True)
            newest = max(newest, t)
    return newest


def cmd_top(argv: List[str]) -> int:
    """Top-K busiest counter series by increase over a trailing
    history window (/queryz op=top) — a quick 'what is this cluster
    doing right now' for operators."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch top")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT")
    p.add_argument("--k", type=int, default=10,
                   help="how many series (default 10)")
    p.add_argument("--window", type=float, default=300.0, metavar="S",
                   help="trailing window in seconds (default 300)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw /queryz response as JSON")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    store = _docserver_client(args.connstr, args.auth, "top")
    if store is None:
        return 2
    try:
        doc = store.queryz({"op": "top", "k": args.k,
                            "window": args.window})
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot query {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        store.close()
    if args.as_json:
        print(json.dumps(doc, indent=2, default=float))
        return 0
    rows = doc.get("series") or []
    print(f"top {len(rows)} counter series over the last "
          f"{doc.get('window_s', args.window):g}s:")
    if not rows:
        print("  (nothing moved — or the history plane is not enabled "
              "on this docserver)")
    for r in rows:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted((r.get("labels")
                                              or {}).items()))
        print("  {:>12.6g}/s  +{:<10g} {}{}".format(
            r.get("rate", 0.0), r.get("increase", 0.0), r.get("name"),
            f"{{{labels}}}" if labels else ""))
    return 0


def cmd_alerts(argv: List[str]) -> int:
    """The alerting plane (/alertz): list rule + instance lifecycle
    state, silence or ack a rule, or --watch the lifecycle live.
    Reads work against ANY replica (standbys tail the shared alert
    log); silence/ack are board mutations and route to the primary."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch alerts")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT (or the HA "
                        "replica-set form H1:P1,H2:P2)")
    p.add_argument("--silence", default=None, metavar="RULE",
                   help="suppress notifications for RULE ('*' = all) "
                        "for --duration; the alert keeps evaluating "
                        "and re-fires when the silence expires")
    p.add_argument("--duration", type=float, default=3600.0,
                   metavar="S",
                   help="--silence length (default 3600s)")
    p.add_argument("--ack", default=None, metavar="RULE",
                   help="mark RULE's firing instances acknowledged")
    p.add_argument("--watch", type=float, default=None, metavar="S",
                   help="re-poll every S seconds until interrupted")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw /alertz JSON instead")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    store = _docserver_client(args.connstr, args.auth, "alerts")
    if store is None:
        return 2
    import time as _time

    try:
        if args.silence is not None:
            res = store.alert_op("silence", args.silence,
                                 duration=args.duration)
            print("silenced {} until {:.0f} (id {})".format(
                res.get("rule"), res.get("until", 0.0),
                res.get("id")))
        if args.ack is not None:
            res = store.alert_op("ack", args.ack)
            print("acked {} ({} firing instance(s))".format(
                res.get("rule"), res.get("acked_instances", 0)))
        while True:
            doc = store.alertz()
            if args.as_json:
                out = json.dumps(doc, indent=2, default=float) + "\n"
            else:
                lines = _render_alerts(doc.get("snapshot") or {})
                out = ("\n".join(lines) + "\n" if lines
                       else "no alert rules configured on this "
                            "docserver (--alert / --alert-rules)\n")
            if args.watch is not None and not args.as_json:
                sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(out)
            sys.stdout.flush()
            if args.watch is None:
                return 0
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        store.close()


def cmd_warmup(argv: List[str]) -> int:
    """Build every kernel library of the device engine's configuration
    (and the host core) into the build directory, and acquire its wave
    program, so that later processes load instead of compiling (the JAX
    CLI's ``warmup``, which primes XLA's persistent cache).  With
    ``--replay``, also precompile every bucket the shape registry
    recorded on this machine."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch warmup")
    p.add_argument("--chunk-len", type=int, default=1 << 22)
    p.add_argument("--cache-dir", default=None,
                   help="the build directory (as --compile-cache DIR)")
    p.add_argument("--bench", action="store_true",
                   help="use the flagship bench's engine config instead "
                        "of the DeviceWordCount default")
    p.add_argument("--tier", choices=("0", "1", "both"), default="both",
                   help="which tier(s) to prime: 0 = the argsort serving "
                        "config, 1 = the steady variadic config, both "
                        "(default) = both")
    p.add_argument("--sort-impl", choices=SORT_IMPLS, default=None,
                   help="prime this sort instead of the --tier mapping "
                        "('radix' builds the radix library; "
                        "'tiered-radix' primes argsort + radix)")
    p.add_argument("--segment-impl", choices=("lax", "pallas"),
                   default=None,
                   help="the config's segmented-reduce formulation name "
                        "(kept for the config's identity, as the "
                        "wordcount example's device_segment_impl: on the "
                        "card the CUDA kernel runs whatever it says)")
    p.add_argument("--tokenize-impl", choices=("lax", "pallas"),
                   default=None,
                   help="the config's tokenizer formulation name; see "
                        "--segment-impl")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="'cpu' builds nothing for the card (the host "
                        "core still builds) and records the CPU program")
    p.add_argument("--replay", action="store_true",
                   help="also precompile EVERY bucket the shape registry "
                        "(obs/compile, kept in the build directory) "
                        "recorded, each on its own partition count")
    p.add_argument("--json", action="store_true",
                   help="end with one JSON line of the libraries, the "
                        "wave program's outcomes and the replay rows")
    _add_compile_cache(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)
    if args.cache_dir:
        args.compile_cache = args.cache_dir
    path = _setup_compile_cache(args)
    from .utils.compile_cache import writable_dir

    if args.compile_cache is False or not writable_dir(path):
        # a warmup that persists nothing is a FAILURE: every later
        # process would build again
        print(f"ERROR: build dir {path!r} is not writable or is this "
              "process's own: this warmup would persist nothing (set "
              "$MAPREDUCE_TPU_CACHE, --compile-cache DIR or --cache-dir "
              "to a writable path)", file=sys.stderr)
        return 1

    from dataclasses import replace as _replace

    from . import native
    from .engine.device_engine import replay_registry
    from .engine.wordcount import DeviceWordCount, bench_engine_config
    from .obs.compile import LEDGER, registry_path
    from .ops import kernel_compat as kc
    from .parallel.mesh import Partitions

    parts = Partitions(1, args.torch_device)
    wc = DeviceWordCount(parts, chunk_len=args.chunk_len,
                         config=bench_engine_config() if args.bench
                         else None)
    cfg = _replace(wc.config, sort_impl=(
        args.sort_impl or {"0": "argsort", "1": "variadic",
                           "both": "tiered"}[args.tier]))
    if args.segment_impl:
        cfg = _replace(cfg, segment_impl=args.segment_impl)
    if args.tokenize_impl:
        cfg = _replace(cfg, tokenize_impl=args.tokenize_impl)
    wc.config = cfg
    secs = wc.warm()
    native.load_library()
    libraries = {}
    for rec in LEDGER.buckets():
        prog = rec["program"]
        compiler, _, label = prog.partition(":")
        if compiler not in ("nvcc", "g++"):
            continue
        # the work done: a library loaded twice (both tiers') is
        # "cached" the second time
        outcome = next(o for o in ("compiled", "persistent_hit", "cached")
                       if o in rec["outcomes"])
        build_s = (kc.BUILD_SECONDS.get(label, 0.0) if compiler == "nvcc"
                   else native.BUILD_SECONDS or 0.0)
        libraries[prog] = {"outcome": outcome, "compiler_s":
                           build_s if outcome == "compiled" else 0.0,
                           "seconds": rec["compile_s"]}
    print(f"built the engine's libraries in {secs:.1f}s -> build dir at "
          f"{path}")
    for prog, row in sorted(libraries.items()):
        print(f"  {prog}: {row['outcome']}, compiler "
              f"{row['compiler_s']:.2f}s, {row['seconds']:.2f}s in all")
    wave = (LEDGER.snapshot().get("programs") or {}).get("wave") or {}
    print(f"  wave program: {wave.get('compiled', 0)} compiled / "
          f"{wave.get('persistent_hit', 0)} persistent hit / "
          f"{wave.get('cached', 0)} cached; shape registry at "
          f"{registry_path(path)}")
    rows = []
    if args.replay:
        rows = replay_registry(path, args.torch_device)
        for row in rows:
            if "seconds" in row:
                print(f"  replayed {row['program']} bucket "
                      f"{row['bucket']}: {row['seconds']:.3f}s")
            else:
                print(f"  skipped {row['program']} bucket "
                      f"{row['bucket']}: {row['skipped']}")
        primed = sum("seconds" in r for r in rows)
        print(f"replay: {primed} bucket(s) primed, "
              f"{len(rows) - primed} skipped")
    tiers: dict = {}
    for rec in LEDGER.buckets():
        if rec.get("program") == "wave":
            t = tiers.setdefault(rec.get("tier"), {"buckets": 0,
                                                   "compile_s": 0.0})
            t["buckets"] += 1
            t["compile_s"] += float(rec.get("compile_s", 0.0))
    names = {0: "tier 0 (argsort serving)", 1: "tier 1 (variadic)",
             2: "tier 2 (radix kernels)", None: "untiered"}
    print("per-tier summary:")
    for t in sorted(tiers, key=lambda x: (x is None, x)):
        print(f"  {names.get(t, t)}: {tiers[t]['buckets']} bucket(s), "
              f"{tiers[t]['compile_s']:.2f}s")
    if args.json:
        print(json.dumps({"warmup": {
            "build_dir": path, "seconds": secs, "libraries": libraries,
            "wave": wave, "replay": rows}}, default=float))
    return 0


def cmd_timeline(argv: List[str]) -> int:
    """Fetch the docserver's /clusterz merged cluster timeline (every
    pushed process's spans clock-aligned with the server's own, one
    Perfetto-loadable file) and write it to --out."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch timeline")
    p.add_argument("connstr",
                   help="the docserver, http://HOST:PORT "
                        "(the same CONNSTR workers use)")
    p.add_argument("--out", required=True, metavar="FILE",
                   help="where to write the merged Chrome trace JSON")
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    store = _docserver_client(args.connstr, args.auth, "timeline")
    if store is None:
        return 2
    try:
        doc = store.clusterz()
    except PermissionError as exc:
        print(f"{exc} (pass --auth or set $MAPREDUCE_TPU_AUTH)",
              file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        store.close()
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=float)
    cluster = doc.get("mrtpuCluster") or {}
    print(f"cluster timeline written to {args.out} "
          f"({len(doc.get('traceEvents') or [])} events from "
          f"{len(cluster.get('procs') or {})} process(es)); open in "
          "https://ui.perfetto.dev")
    return 0


def cmd_runner(argv: List[str]) -> int:
    """The always-on serving process: a lease-fenced TaskRunner (ticks
    admission, drives every admitted task through Server.loop on this
    process's partitions of the card) plus a pool of cross-tenant
    workers claiming over every admitted task's board
    (sched/service.py).  Point it at the same CONNSTR the docserver
    serves; submit work with ``cli submit``.  Admission is
    telemetry-informed: the runner registers its own placement facts
    (warm program tokens, card memory) with an ``AdmissionAdvisor``
    under its host id and refreshes them while it serves.  It joins the
    engine-host fleet under the same id (coord/fleet), heartbeats those
    facts every turn, rejoins after a definitive loss, steps down when
    ``cli drain`` flags it and leaves cleanly on exit.  ``--slo`` sets
    the objectives the SLO plane of this process evaluates; the
    lifecycle histograms it observes reach the board's /statusz through
    the telemetry pushes."""
    p = argparse.ArgumentParser(
        prog="mapreduce_tpu_torch runner",
        description="The always-on serving process: admission and a "
                    "cross-tenant worker pool over a docserver's "
                    "scheduler, routed by an admission advisor fed this "
                    "process's warm programs and card memory.  It joins "
                    "the engine-host fleet and steps down when `drain` "
                    "flags it.")
    p.add_argument("connstr",
                   help="the job board (http://HOST:PORT docserver — "
                        "or the HA replica set http://H1:P1,H2:P2, the "
                        "runner fails over with the board — or "
                        "mem://NAME / dir:///PATH for in-process use)")
    p.add_argument("--workers", type=int, default=4,
                   help="cross-tenant worker threads in this process")
    p.add_argument("--max-inflight", type=int, default=2,
                   help="tasks admitted+running at once")
    p.add_argument("--job-lease", type=float, default=None, metavar="S")
    p.add_argument("--partitions", type=int, default=1,
                   help="device-engine partitions on the one card that "
                        "every device task runs over (the JAX mesh's "
                        "data axis)")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where device tasks run; 'cpu' runs each "
                        "kernel's plain PyTorch version")
    p.add_argument("--telemetry-interval", type=float, default=1.0,
                   metavar="S",
                   help="push span/metric batches to the board's "
                        "collector every S seconds (0 disables; http "
                        "boards only).  The SLO lifecycle histograms "
                        "(queue wait, admit->running, submit->first "
                        "result) live in THIS process; pushing them "
                        "puts them on the board's /clusterz")
    _add_slo(p)
    _add_compile_cache(p)
    _add_auth(p)
    _add_retry(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    _setup_slo(args)
    rec = _setup_trace(args)
    _setup_compile_cache(args)

    from .coord import docstore
    from .coord.fleet import FleetMember, FleetRegistry, default_host_id
    from .engine.autotune import AdmissionAdvisor, local_mesh_facts
    from .obs.collector import acquire_pusher, release_pusher
    from .parallel.mesh import Partitions
    from .sched.scheduler import Scheduler, SchedulerConfig
    from .sched.service import TaskRunner, spawn_scheduled_workers
    from .utils.httpclient import default_auth_token, split_embedded_token

    retry = _retry_policy(args)
    # the card (or the CPU, asked by name) first: a runner that cannot
    # serve device tasks fails here, before it takes the admission lease
    parts = Partitions(args.partitions, args.torch_device)
    store = docstore.connect(args.connstr, auth=args.auth, retry=retry)
    # telemetry-informed admission: this process hosts the admitted
    # tasks' engines, so ITS warm programs and card memory are the
    # placement facts, registered under its fleet host id (hostname:pid:
    # two runners on one board must not clobber each other) and
    # refreshed while it serves
    advisor = AdmissionAdvisor()
    host_id = default_host_id()
    warm, hbm = local_mesh_facts()
    advisor.register_mesh(host_id, warm_programs=warm, hbm_frac=hbm)
    # join the engine-host fleet: the same facts heartbeat to the board
    # so a docserver-side scheduler places across EVERY runner, `cli
    # drain` can ask this one to step down, and a SIGKILL here is
    # recovered by the scheduler's failed-host sweep one lease later
    member = FleetMember(store, host_id=host_id)
    try:
        member.join(timeout=10.0, warm_programs=warm, hbm_frac=hbm)
    except (OSError, TimeoutError) as exc:
        print(f"fleet join failed ({exc}); serving without fleet "
              "membership", file=sys.stderr)
        member = None
    scheduler = Scheduler(
        store, config=SchedulerConfig(max_inflight=args.max_inflight),
        advisor=advisor,
        fleet=FleetRegistry(store) if member is not None else None)
    # normalized HOST:PORT (the one embedded-token parser): a TOKEN@
    # connstr must key the SAME shared pusher the pool's workers use
    board, embedded = None, None
    if args.connstr.startswith("http://"):
        embedded, board = split_embedded_token(
            args.connstr[len("http://"):])
    tele = acquire_pusher(board,
                          default_auth_token(args.auth or embedded),
                          role="runner",
                          interval=args.telemetry_interval)
    runner = TaskRunner(args.connstr, scheduler, auth=args.auth,
                        retry=retry, job_lease=args.job_lease,
                        partitions=parts).start()
    pool = spawn_scheduled_workers(args.connstr, args.workers,
                                   auth=args.auth, retry=retry,
                                   job_lease=args.job_lease)
    print(f"runner serving {args.connstr}: admission + {args.workers} "
          f"cross-tenant worker(s), {parts.n} partition(s) on "
          f"{parts.device}; submit with `cli submit`", flush=True)
    rc = 0
    try:
        # a runner (or any pool worker) that stopped itself — auth
        # rejected by the board — exits with the diagnosis, never idles
        # as a zombie advertising workers it no longer has
        while not runner._stop.wait(1.0):
            # keep the advisor's facts live: warmth grows as tasks build
            # their kernels, memory moves at every wave
            warm, hbm = local_mesh_facts()
            advisor.register_mesh(host_id, warm_programs=warm,
                                  hbm_frac=hbm)
            if member is not None:
                # fleet heartbeat: liveness + the same facts in one
                # guarded write; the post-image carries the board's
                # requests back (the `cli drain` flag)
                try:
                    doc = member.heartbeat(warm_programs=warm,
                                           hbm_frac=hbm)
                except OSError:
                    doc = {}  # transport blip: proves nothing
                if doc is None:
                    # definitive loss (reaped or superseded): our
                    # streams may already serve elsewhere; rejoin fresh
                    try:
                        member.join(timeout=2.0, warm_programs=warm,
                                    hbm_frac=hbm)
                    except (OSError, TimeoutError):
                        pass
                elif doc.get("drain"):
                    print(f"drain requested for host {host_id}: "
                          "stepping down (streams re-home via the "
                          "fleet routes + spill store)", flush=True)
                    break
            if any(w.failed is not None for w in pool):
                break
        failure = runner.failed or next(
            (w.failed for w in pool if w.failed is not None), None)
        if failure is not None:
            print(f"{failure} (pass --auth or set "
                  "$MAPREDUCE_TPU_AUTH)", file=sys.stderr)
            rc = 2
    except KeyboardInterrupt:
        pass
    finally:
        runner.stop()
        for w in pool:
            w.stop()
        if member is not None:
            try:
                # clean departure: the host shows as LEFT (not
                # expired), so no recovery sweep fires for a shutdown
                member.leave()
            except OSError:
                pass  # board gone too; the sweep will reap us
        release_pusher(tele)
    _export_trace(args, rec)
    return rc


def cmd_drain(argv: List[str]) -> int:
    """Upgrade-safe host removal: flag the engine host for drain (it
    sees the flag on its next heartbeat, steps down and releases its
    lease), wait for it to leave, then re-home every stream routed at
    it to the best live hosts (coord/fleet.rehome_routes: guarded
    route flips, scored like admission, each move a control-ledger
    decision).  The streams are durable in the spill store, so the
    re-home is a route flip: the destinations pay a lazy restore on
    each stream's next feed or snapshot.  On an http board the moves'
    counters reach the collector (a final telemetry flush), so
    ``diagnose`` names them."""
    p = argparse.ArgumentParser(prog="mapreduce_tpu_torch drain")
    p.add_argument("connstr", help="the job board (same CONNSTR the "
                                   "runner serves)")
    p.add_argument("host", help="fleet host id (hostname:pid; the "
                                "`cli status` fleet section lists "
                                "them)")
    p.add_argument("--timeout", type=float, default=30.0, metavar="S",
                   help="seconds to wait for the host to see the flag "
                        "and leave before re-homing anyway")
    _add_auth(p)
    _add_retry(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)

    import time as _time

    from .coord import docstore
    from .coord.fleet import FleetRegistry, host_state, rehome_routes
    from .obs import control as _control
    from .obs.collector import acquire_pusher, release_pusher
    from .utils.httpclient import default_auth_token, split_embedded_token

    retry = _retry_policy(args)
    store = docstore.connect(args.connstr, auth=args.auth, retry=retry)
    board, embedded = None, None
    if args.connstr.startswith("http://"):
        embedded, board = split_embedded_token(
            args.connstr[len("http://"):])
    # released below with a final flush: the migration counters and the
    # ledger's decisions reach the board's /clusterz
    tele = acquire_pusher(board, default_auth_token(args.auth or embedded),
                          role="drain", interval=1.0)
    try:
        reg = FleetRegistry(store)

        def _doc():
            return next((d for d in reg.hosts()
                         if str(d["_id"]) == args.host), None)

        doc = _doc()
        if doc is None:
            print(f"no such fleet host: {args.host!r} (see the fleet "
                  "section of `cli status`)", file=sys.stderr)
            return 2
        state = host_state(doc, docstore.now())
        if state in ("live", "draining"):
            reg.request_drain(args.host)
            print(f"drain requested for {args.host} ({state}); "
                  f"waiting up to {args.timeout:.0f}s for it to step "
                  "down...", flush=True)
            give_up = _time.monotonic() + args.timeout
            while _time.monotonic() < give_up:
                doc = _doc()
                if doc is None or host_state(
                        doc, docstore.now()) in ("left", "expired"):
                    break
                _time.sleep(0.25)
            else:
                print(f"host {args.host} did not leave within "
                      f"{args.timeout:.0f}s; re-homing its routes "
                      "anyway (its guarded writes fence once the "
                      "routes move)", file=sys.stderr)
        moves = rehome_routes(reg, args.host, reason="drain",
                              ledger=_control.LEDGER)
        for task, dst in moves:
            print(f"  re-homed stream {task} -> {dst}")
        left = reg.routes_for(args.host)
        doc = _doc()
        print("host {} {}: {} stream(s) re-homed, {} still routed "
              "here{}".format(
                  args.host,
                  host_state(doc, docstore.now()) if doc else "gone",
                  len(moves), len(left),
                  "" if not left else
                  " (no live destination yet — the scheduler's next "
                  "sweep retries)"))
        return 0 if not left else 1
    except OSError as exc:
        print(f"cannot reach {args.connstr}: {exc}", file=sys.stderr)
        return 1
    finally:
        release_pusher(tele)
        store.close()


COMMANDS = {"server": cmd_server, "worker": cmd_worker,
            "wordcount": cmd_wordcount, "train": cmd_train,
            "docserver": cmd_docserver, "blobserver": cmd_blobserver,
            "drop": cmd_drop, "submit": cmd_submit, "tasks": cmd_tasks,
            "runner": cmd_runner, "timeline": cmd_timeline,
            "warmup": cmd_warmup, "status": cmd_status,
            "profile": cmd_profile, "diagnose": cmd_diagnose,
            "history": cmd_history, "top": cmd_top,
            "alerts": cmd_alerts, "drain": cmd_drain}

#: JAX commands the port does not offer yet, with the ROADMAP item
#: (none: every JAX command is served)
NOT_PORTED_COMMANDS: Dict[str, str] = {}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED_COMMANDS:
        print(f"{cmd!r} is not ported to mapreduce_tpu_torch yet "
              f"({NOT_PORTED_COMMANDS[cmd]})", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    from .utils import compile_cache

    # a command run in process (tests, the smoke) leaves the build dir
    # and the registry as it found them
    saved = compile_cache.save_state()
    try:
        return COMMANDS[cmd](argv[1:])
    finally:
        compile_cache.restore_state(saved)


if __name__ == "__main__":
    raise SystemExit(main())
