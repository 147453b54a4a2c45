"""Command line of the port — the reference's L5 layer (execute_server.lua
/ execute_worker.lua, SURVEY.md §1; port of ``mapreduce_tpu/cli.py``):

  python -m mapreduce_tpu_torch.cli server CONNSTR DB TASKFN MAPFN
      PARTITIONFN REDUCEFN [FINALFN] [COMBINERFN] [STORAGE]
      [--init-args JSON] [--result-ns NS]
  python -m mapreduce_tpu_torch.cli worker CONNSTR DB [--workers N]
      [--max-iter N] [--max-sleep S] [--max-tasks N] [--claim-batch N]
      [--no-claim-ahead] [--name NAME]
  python -m mapreduce_tpu_torch.cli docserver [--host H] [--port N]
      [--root DIR] — the job board over HTTP (the mongod role)
  python -m mapreduce_tpu_torch.cli blobserver ROOT [--host H]
      [--port N] [--no-gzip] — the ``http:HOST:PORT`` blob service
  python -m mapreduce_tpu_torch.cli drop CONNSTR DB [--storage DSL]
  python -m mapreduce_tpu_torch.cli wordcount FILES... [--device]
      [--workers N] [--num-reducers N] [--sort-impl IMPL]
      [--partitions N] [--torch-device {cuda,cpu}]
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
Chrome trace JSON at exit).  Every command takes ``-v``.

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

JAX flags the port does not offer yet are refused by name, their help
naming the ROADMAP item that brings them: ``--autotune`` and
``--speculative-reclaim`` (A.7); the docserver's ``--ha-*`` (A.4b-2),
``--max-inflight`` and ``--tenant-*`` (A.4c), ``--history-*``,
``--alert*`` and ``--slo`` (A.8); ``--compile-cache`` (A.8).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import uuid
from typing import List, Optional

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


def _setup_trace(args) -> None:
    """Apply the ring bound BEFORE any span records."""
    if args.trace_max_events:
        from .obs.trace import TRACER

        TRACER.max_events = max(1, args.trace_max_events)


def _export_trace(args) -> None:
    if args.trace_out:
        from .obs.trace import TRACER

        print(f"trace written to {TRACER.export(args.trace_out)}",
              file=sys.stderr)


class _NotPorted(argparse.Action):
    """A JAX flag the port does not offer yet: refused by name, never
    accepted and then ignored."""

    def __init__(self, option_strings, dest, item, nargs=0, **kw):
        self.item = item
        super().__init__(option_strings, dest, nargs=nargs,
                         help=f"not ported yet ({item})", **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to "
                     f"mapreduce_tpu_torch yet ({self.item})")


def _refuse(p: argparse.ArgumentParser, item: str, *flags: str,
            takes_value: bool = False) -> None:
    for flag in flags:
        p.add_argument(flag, action=_NotPorted, item=item,
                       nargs=1 if takes_value else 0,
                       default=argparse.SUPPRESS)


def _refuse_job_flags(p: argparse.ArgumentParser) -> None:
    """The JAX job commands' flags that wait for the autotune
    controllers (A.7) and the compile observability (A.8)."""
    _refuse(p, "ROADMAP A.7", "--autotune", "--no-autotune",
            "--speculative-reclaim", "--no-speculative-reclaim")
    _refuse(p, "ROADMAP A.8", "--compile-cache", "--no-compile-cache")


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
    _refuse_job_flags(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose)
    _setup_trace(args)

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
    _export_trace(args)
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
    _refuse(p, "ROADMAP A.8", "--compile-cache", "--no-compile-cache")
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    _setup_trace(args)

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
            _export_trace(args)
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
        _export_trace(args)
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
    _refuse_job_flags(p)
    _add_auth(p)
    _add_retry(p)
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    _setup_trace(args)

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
    server.telemetry_interval = args.telemetry_interval
    server.configure(params)
    stats = server.loop()
    print(json.dumps(stats, default=float))
    _export_trace(args)
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
    _refuse(p, "ROADMAP A.8", "--compile-cache", "--no-compile-cache")
    _add_trace(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)
    _setup_trace(args)

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
    _export_trace(args)
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
    _refuse(p, "ROADMAP A.4b-2: the replicated board", "--ha-fsync")
    _refuse(p, "ROADMAP A.4b-2: the replicated board", "--ha-dir",
            "--ha-lease", takes_value=True)
    _refuse(p, "ROADMAP A.4c: the scheduler", "--max-inflight",
            "--tenant-max-queued-tasks", "--tenant-max-queued-jobs",
            "--tenant-max-queued-bytes", takes_value=True)
    _refuse(p, "ROADMAP A.8: telemetry history, alerts, SLOs",
            "--history-dir", "--history-keep", "--history-segment-bytes",
            "--history-max-age", "--alert", "--alert-rules",
            "--alert-webhook", "--alert-exec", "--alert-interval",
            "--alert-damp", "--slo", takes_value=True)
    _add_auth(p)
    _add_verbosity(p)
    args = p.parse_args(argv)
    _setup_logging(args.verbose or 1)

    from .coord.docserver import DocServer
    from .coord.docstore import DirDocStore

    store = DirDocStore(args.root) if args.root else None
    srv = DocServer(store, args.host, args.port, auth_token=args.auth)
    print(f"job board at http://{srv.host}:{srv.port} "
          f"(CONNSTR: \"http://HOST:{srv.port}\"; Prometheus at "
          f"/metrics, merged cluster timeline at /clusterz)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
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


COMMANDS = {"server": cmd_server, "worker": cmd_worker,
            "wordcount": cmd_wordcount, "train": cmd_train,
            "docserver": cmd_docserver, "blobserver": cmd_blobserver,
            "drop": cmd_drop}


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
