"""Durable telemetry history (port of ``mapreduce_tpu/obs/history.py``).

A :class:`MetricHistory` store that every collector push appends to,
written as seq-stamped append-only JSONL *segments* through the port's
:class:`~mapreduce_tpu_torch.coord.persistent_table.MutationLog`, on any
directory-shaped backend (a local dir, the blob plane's POSIX mount, or
the HA dir — where a standby docserver tails the segments and keeps
serving ``/queryz`` after failover).  The segment format is the JAX
package's byte for byte, so either package loads the other's segments.

Data model — one JSONL entry per *changed* push batch:

* counter-like series (``_total`` / ``_bucket`` / ``_count`` /
  ``_sum``) are **delta-encoded**: each row stores both the increase
  since the proc's previous snapshot AND the cumulative value, so
  window math is a pure sum of persisted deltas (reset-aware: a
  counter that went backwards contributes its new cumulative, exactly
  Prometheus ``increase()`` semantics);
* gauges store the absolute value;
* every entry carries the pushing proc id, a per-proc ``seq`` stamp,
  the wall timestamp (minted once at the collector via
  ``coord.docstore.now``; the pusher's clock offset estimate rides
  along in ``off`` for audit), and the changed rows.

The device families the card's runners push — ``mrtpu_kernel_launches_
total{kernel}``, ``mrtpu_device_waves_total``, ``mrtpu_device_seconds_
total``, ``mrtpu_exchange_records_total`` — are stored like any other
counter, so ``/queryz`` answers how many kernel launches a window saw.

Idempotency: a re-sent batch whose metrics did not move produces NO
entry (every row is a delta against the proc's last cumulative), and
replayed entries at or below a proc's ``seq`` high-water mark are
skipped on load/refresh — so tailing writers (primary + promoted
standby on a shared dir) converge on one series with no gap and no
double-count.

Durability: size/age-based segment rotation, keep-N retention, and
strict :func:`validate_history` on BOTH write and load — a garbled
complete line raises :class:`HistoryCorruptError` instead of serving a
silently wrong series.

Local durations come from ``time.monotonic``; persisted wall stamps are
minted through ``coord.docstore.now``, never ``time.time``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import LabelKey, counter, fraction_le, gauge, histogram

__all__ = [
    "HistoryCorruptError", "MetricHistory", "validate_history",
    "counter_like", "read_history", "SEGMENT_PREFIX", "SEGMENT_SUFFIX",
]


class HistoryCorruptError(RuntimeError):
    """A history segment holds a garbled complete line or an entry that
    fails :func:`validate_history` — refused loudly, never served."""


#: segment file naming: ``seg-00000001.jsonl`` — zero-padded so
#: lexicographic order IS creation order
SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".jsonl"
_SEGMENT_DIGITS = 8

#: default knobs (CLI flags --history-segment-bytes / --history-max-age
#: / --history-keep override them)
DEFAULT_SEGMENT_BYTES = 1_000_000
DEFAULT_SEGMENT_AGE_S = 300.0
DEFAULT_KEEP_SEGMENTS = 8
#: in-memory samples retained per (series, proc) — queries serve from
#: memory (rebuilt from segments on load), so this bounds RSS the same
#: way keep-N bounds disk
DEFAULT_MAX_SAMPLES = 2048

#: counter families whose old-window vs new-window rates feed the
#: trend-aware diagnosis (retry / lease-loss / failover pressure —
#: families where "trending up" is a regression by definition)
TREND_RATE_FAMILIES: Tuple[str, ...] = (
    "mrtpu_http_retries_total",
    "mrtpu_http_exhausted_total",
    "mrtpu_worker_lease_lost_total",
    "mrtpu_device_retries_total",
    "mrtpu_client_failovers_total",
    "mrtpu_board_fences_total",
    "mrtpu_session_backpressure_total",
    "mrtpu_telemetry_dropped_total",
)

#: an offset estimate that moves more than this between trend windows
#: is flagged — Cristian's estimate only tightens within one pusher's
#: lifetime, so a jump means a pusher restart or a moved clock
OFFSET_JUMP_S = 0.025

# -- instruments -------------------------------------------------------------
_APPENDS = counter(
    "mrtpu_history_appends_total",
    "history entries appended (at most one per push batch; an unchanged"
    " batch appends nothing — that is the idempotency contract)")
_APPEND_SECONDS = histogram(
    "mrtpu_history_append_seconds",
    "wall-clock-free append_snapshot latency (diff + validate + "
    "O_APPEND write), observed on every call including no-op batches")
_ERRORS = counter(
    "mrtpu_history_errors_total",
    "history plane errors swallowed by the collector so telemetry "
    "keeps flowing (labels: kind=io|corrupt)")
_ROTATIONS = counter(
    "mrtpu_history_rotations_total",
    "segment rotations (labels: reason=size|age)")
_RETIRED = counter(
    "mrtpu_history_retired_segments_total",
    "segments deleted by keep-N retention")
_GC = counter(
    "mrtpu_history_gc_total",
    "segments garbage-collected by keep-N retention, labelled with the"
    " rotation reason (size|age) whose sweep reclaimed them")
_SEGMENTS_G = gauge(
    "mrtpu_history_segments", "live history segment files")
_BYTES_G = gauge(
    "mrtpu_history_bytes", "total bytes across live history segments")


def counter_like(name: str) -> bool:
    """Repo naming contract: counters end ``_total``; histogram series
    end ``_bucket`` / ``_count`` / ``_sum``; everything else is a
    gauge.  This is what lets history delta-encode without type info
    in the exposition text."""
    return name.endswith(("_total", "_bucket", "_count", "_sum"))


def _wall_now() -> float:
    from ..coord import docstore  # the one wall-clock mint point
    return docstore.now()


def validate_history(entry: Any) -> None:
    """Strict per-entry schema check, applied on WRITE and on LOAD.

    Raises :class:`HistoryCorruptError`; never repairs.  Shape::

        {"v": 1, "proc": str, "seq": int>=1, "t": float,
         "s": [[name, {labels}, delta|null, value, "c"|"g"], ...],
         "off": float?, "role": str?}
    """
    if not isinstance(entry, dict):
        raise HistoryCorruptError(f"history entry is not an object: "
                                  f"{type(entry).__name__}")
    if entry.get("v") != 1:
        raise HistoryCorruptError(
            f"unknown history entry version {entry.get('v')!r}")
    proc = entry.get("proc")
    if not isinstance(proc, str) or not proc:
        raise HistoryCorruptError("history entry missing proc id")
    seq = entry.get("seq")
    if not isinstance(seq, int) or seq < 1:
        raise HistoryCorruptError(f"bad history seq {seq!r}")
    t = entry.get("t")
    if not isinstance(t, (int, float)) or not t > 0:
        raise HistoryCorruptError(f"bad history timestamp {t!r}")
    off = entry.get("off")
    if off is not None and not isinstance(off, (int, float)):
        raise HistoryCorruptError(f"bad history offset {off!r}")
    rows = entry.get("s")
    if not isinstance(rows, list) or not rows:
        raise HistoryCorruptError("history entry has no sample rows")
    for row in rows:
        if not (isinstance(row, list) and len(row) == 5):
            raise HistoryCorruptError(f"bad history row shape: {row!r}")
        name, labels, delta, value, kind = row
        if not (isinstance(name, str) and name.startswith("mrtpu_")):
            raise HistoryCorruptError(f"bad history family {name!r}")
        if not isinstance(labels, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in labels.items()):
            raise HistoryCorruptError(f"bad history labels in {name}")
        if not isinstance(value, (int, float)):
            raise HistoryCorruptError(f"bad history value in {name}")
        if kind == "c":
            if not isinstance(delta, (int, float)) or delta < 0:
                raise HistoryCorruptError(
                    f"bad counter delta {delta!r} in {name}")
        elif kind == "g":
            if delta is not None:
                raise HistoryCorruptError(
                    f"gauge row {name} carries a delta")
        else:
            raise HistoryCorruptError(f"bad history kind {kind!r}")


def _encode(entry: Dict[str, Any]) -> bytes:
    # byte-identical to MutationLog's encoding (sort_keys + separators)
    return (json.dumps(entry, separators=(",", ":"), sort_keys=True)
            + "\n").encode()


def _read_segment(path: str, offset: int,
                  ) -> Tuple[List[Dict[str, Any]], int]:
    """Tail complete, validated lines from *path* starting at *offset*
    (the :meth:`MutationLog.read_from` contract: a trailing partial
    line is left for the next poll; a garbled COMPLETE line raises)."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    entries: List[Dict[str, Any]] = []
    consumed = 0
    for line in data.split(b"\n")[:-1]:
        consumed += len(line) + 1
        if not line.strip():
            continue
        try:
            entry = json.loads(line)
        except ValueError:
            raise HistoryCorruptError(
                f"garbled history line in {os.path.basename(path)} "
                f"near offset {offset + consumed - len(line) - 1}")
        validate_history(entry)
        entries.append(entry)
    return entries, offset + consumed


class MetricHistory:
    """Append-only, segment-rotated, tail-replayable metric history.

    Thread-safe; safe for a primary and a promoted standby to share
    one directory (O_APPEND interleaving + per-proc seq idempotency).
    """

    def __init__(self, directory: str, *, fsync: bool = False,
                 max_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segment_age_s: float = DEFAULT_SEGMENT_AGE_S,
                 keep_segments: int = DEFAULT_KEEP_SEGMENTS,
                 max_samples_per_series: int = DEFAULT_MAX_SAMPLES,
                 ) -> None:
        self.dir = str(directory)
        self.fsync = bool(fsync)
        self.max_segment_bytes = max(4096, int(max_segment_bytes))
        self.max_segment_age_s = float(max_segment_age_s)
        self.keep_segments = max(1, int(keep_segments))
        self.max_samples = max(16, int(max_samples_per_series))
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        self._writer: Optional[Any] = None      # MutationLog
        self._writer_name: Optional[str] = None
        # series -> proc -> [(t_wall, delta|None, value), ...]
        self._series: Dict[Tuple[str, LabelKey],
                           Dict[str, List[Tuple[float, Optional[float],
                                                float]]]] = {}
        self._last: Dict[str, Dict[Tuple[str, LabelKey], float]] = {}
        self._applied: Dict[str, int] = {}      # proc -> seq high-water
        self._offsets: Dict[str, int] = {}      # segment -> bytes read
        self._seg_first_t: Dict[str, float] = {}
        self._offset_hist: Dict[str, List[Tuple[float, float]]] = {}
        self._entries = 0
        self._rotations = 0
        self._gc_segments = 0
        self._oldest_t: Optional[float] = None
        self._newest_t: Optional[float] = None

    # -- segment plumbing --------------------------------------------------

    def _segment_files(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if n.startswith(SEGMENT_PREFIX)
                      and n.endswith(SEGMENT_SUFFIX))

    @staticmethod
    def _segment_name(index: int) -> str:
        return (f"{SEGMENT_PREFIX}{index:0{_SEGMENT_DIGITS}d}"
                f"{SEGMENT_SUFFIX}")

    @staticmethod
    def _segment_index(name: str) -> int:
        core = name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
        try:
            return int(core)
        except ValueError:
            return 0

    def _ensure_writer_locked(self) -> None:
        from ..coord.persistent_table import MutationLog
        segs = self._segment_files()
        newest = segs[-1] if segs else self._segment_name(1)
        if self._writer is None or self._writer_name != newest:
            if self._writer is not None:
                self._writer.close()
            self._writer = MutationLog(os.path.join(self.dir, newest),
                                       fsync=self.fsync)
            self._writer_name = newest

    def _rotate_locked(self, reason: str) -> None:
        assert self._writer_name is not None
        nxt = self._segment_index(self._writer_name) + 1
        if self._writer is not None:
            self._writer.close()
        from ..coord.persistent_table import MutationLog
        self._writer_name = self._segment_name(nxt)
        self._writer = MutationLog(
            os.path.join(self.dir, self._writer_name), fsync=self.fsync)
        _ROTATIONS.inc(reason=reason)
        self._rotations += 1
        # keep-N retention: oldest segments (and their read state) go
        segs = self._segment_files()
        while len(segs) > self.keep_segments:
            victim = segs.pop(0)
            try:
                os.unlink(os.path.join(self.dir, victim))
            except FileNotFoundError:
                pass
            self._offsets.pop(victim, None)
            self._seg_first_t.pop(victim, None)
            _RETIRED.inc()
            _GC.inc(reason=reason)
            self._gc_segments += 1

    def _disk_stats_locked(self) -> Tuple[int, int]:
        total = 0
        segs = self._segment_files()
        for name in segs:
            try:
                total += os.stat(os.path.join(self.dir, name)).st_size
            except FileNotFoundError:
                pass
        _SEGMENTS_G.set(len(segs))
        _BYTES_G.set(total)
        return len(segs), total

    # -- replay / tailing --------------------------------------------------

    def _refresh_locked(self) -> int:
        """Tail every segment from its consumed offset and apply new
        entries idempotently — the read path a promoted standby (or a
        restarted docserver) rebuilds its series state through."""
        applied = 0
        for name in self._segment_files():
            path = os.path.join(self.dir, name)
            try:
                size = os.stat(path).st_size
            except FileNotFoundError:
                continue
            off = self._offsets.get(name, 0)
            if size <= off:
                continue
            entries, new_off = _read_segment(path, off)
            for entry in entries:
                if name not in self._seg_first_t:
                    self._seg_first_t[name] = float(entry["t"])
                if self._apply_locked(entry):
                    applied += 1
            self._offsets[name] = new_off
        return applied

    def _apply_locked(self, entry: Dict[str, Any]) -> bool:
        proc = entry["proc"]
        seq = int(entry["seq"])
        if seq <= self._applied.get(proc, 0):
            return False    # replayed / self-appended: already counted
        self._applied[proc] = seq
        t = float(entry["t"])
        off = entry.get("off")
        if isinstance(off, (int, float)):
            hist = self._offset_hist.setdefault(proc, [])
            hist.append((t, float(off)))
            if len(hist) > self.max_samples:
                del hist[:len(hist) - self.max_samples]
        last = self._last.setdefault(proc, {})
        for name, labels, delta, value, kind in entry["s"]:
            lk: LabelKey = tuple(sorted(
                (k, str(v)) for k, v in labels.items()))
            key = (name, lk)
            arr = self._series.setdefault(key, {}).setdefault(proc, [])
            d = None if kind == "g" else float(delta)
            sample = (t, d, float(value))
            if arr and t < arr[-1][0]:
                i = len(arr)
                while i > 0 and arr[i - 1][0] > t:
                    i -= 1
                arr.insert(i, sample)
            else:
                arr.append(sample)
            if len(arr) > self.max_samples:
                del arr[:len(arr) - self.max_samples]
            last[key] = float(value)
        self._entries += 1
        if self._oldest_t is None or t < self._oldest_t:
            self._oldest_t = t
        if self._newest_t is None or t > self._newest_t:
            self._newest_t = t
        return True

    def load(self) -> int:
        """Full replay of every on-disk segment (startup path).  Raises
        :class:`HistoryCorruptError` on a garbled segment — a corrupt
        history refuses to load rather than serve wrong series."""
        with self._lock:
            return self._refresh_locked()

    def refresh(self) -> int:
        """Tail new bytes appended by any writer since the last call."""
        with self._lock:
            return self._refresh_locked()

    # -- the write path ----------------------------------------------------

    def _changed_rows_locked(self, proc: str, parsed: Dict[Any, float],
                             ) -> List[List[Any]]:
        last = self._last.get(proc) or {}
        rows: List[List[Any]] = []
        for key in sorted(parsed):
            name, lk = key
            if not name.startswith("mrtpu_"):
                continue
            v = float(parsed[key])
            prev = last.get(key)
            if prev is not None and v == prev:
                continue
            if counter_like(name):
                # reset-aware delta: first sight (or a counter that
                # went backwards, i.e. a restarted proc reusing an id)
                # contributes its full cumulative — increase() math
                delta = v if (prev is None or v < prev) else v - prev
                if delta == 0:
                    continue
                rows.append([name, dict(lk), delta, v, "c"])
            else:
                rows.append([name, dict(lk), None, v, "g"])
        return rows

    def append_snapshot(self, proc: str, parsed: Dict[Any, float], *,
                        role: Optional[str] = None,
                        offset_s: Optional[float] = None,
                        t: Optional[float] = None) -> bool:
        """Diff one pushed metrics snapshot against *proc*'s last and
        append the changed rows as one seq-stamped entry.  Returns
        whether an entry was written (an unchanged batch — e.g. a
        re-sent push — writes nothing: that is the no-double-count
        contract)."""
        t0 = time.monotonic()
        try:
            with self._lock:
                # pick up any other writer's tail first so deltas are
                # computed against the converged cumulative state
                self._refresh_locked()
                rows = self._changed_rows_locked(proc, parsed)
                if not rows:
                    return False
                entry: Dict[str, Any] = {
                    "v": 1, "proc": str(proc),
                    "seq": self._applied.get(proc, 0) + 1,
                    "t": float(t) if t is not None else _wall_now(),
                    "s": rows,
                }
                if role:
                    entry["role"] = str(role)
                if offset_s is not None:
                    entry["off"] = round(float(offset_s), 6)
                validate_history(entry)
                self._ensure_writer_locked()
                if (self._writer_name is not None
                        and self._writer_name not in self._seg_first_t):
                    self._seg_first_t[self._writer_name] = entry["t"]
                self._writer.append(entry)
                self._apply_locked(entry)
                first_t = self._seg_first_t.get(self._writer_name or "")
                if self._writer.size() >= self.max_segment_bytes:
                    self._rotate_locked("size")
                elif (first_t is not None and self.max_segment_age_s > 0
                      and entry["t"] - first_t >= self.max_segment_age_s):
                    self._rotate_locked("age")
                self._disk_stats_locked()
            _APPENDS.inc()
            return True
        finally:
            _APPEND_SECONDS.observe(time.monotonic() - t0)

    # -- query surface -----------------------------------------------------

    def _resolve_range(self, start: Optional[float], end: Optional[float],
                       now: Optional[float]) -> Tuple[float, float]:
        """Range endpoints: absolute wall seconds, or <= 0 meaning
        relative to now (``start=-600`` → the trailing 10 minutes)."""
        if now is None:
            now = _wall_now()
        end_t = now if end is None else (now + end if end <= 0 else
                                         float(end))
        start_t = (end_t - 600.0 if start is None else
                   (now + start if start <= 0 else float(start)))
        if start_t >= end_t:
            raise ValueError(f"empty history range "
                             f"[{start_t}, {end_t}]")
        return start_t, end_t

    def _pick_locked(self, metric: str,
                     matchers: Optional[Dict[str, str]],
                     ) -> Dict[LabelKey, Dict[str, List[Tuple[
                         float, Optional[float], float]]]]:
        out: Dict[LabelKey, Dict[str, List[Tuple[float, Optional[float],
                                                 float]]]] = {}
        for (name, lk), per in self._series.items():
            if name != metric:
                continue
            if matchers:
                labels = dict(lk)
                if any(labels.get(k) != str(v)
                       for k, v in matchers.items()):
                    continue
            out[lk] = {proc: list(arr) for proc, arr in per.items()}
        return out

    @staticmethod
    def _increase(arr: List[Tuple[float, Optional[float], float]],
                  start_t: float, end_t: float) -> float:
        """Sum of persisted deltas with ``start < t <= end`` — the
        whole point of delta encoding: window math that a replayed or
        re-sent batch cannot inflate."""
        return sum(d for (t, d, _v) in arr
                   if d is not None and start_t < t <= end_t)

    def query(self, metric: str,
              matchers: Optional[Dict[str, str]] = None,
              start: Optional[float] = None, end: Optional[float] = None,
              step: Optional[float] = None, fn: str = "raw",
              by_proc: bool = False,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Range query → aligned series.

        ``fn='raw'`` returns the stored samples (cumulative for
        counters, values for gauges), always split per proc.
        ``fn='increase'|'delta'|'rate'`` on counters sums persisted
        deltas per step bucket (aligned to the step grid), across
        procs unless *by_proc*; on gauges, delta/rate use last-first
        over the window.
        """
        if fn not in ("raw", "rate", "increase", "delta"):
            raise ValueError(f"bad queryz fn {fn!r}")
        start_t, end_t = self._resolve_range(start, end, now)
        if step is not None:
            step = float(step)
            if step <= 0:
                raise ValueError(f"bad queryz step {step!r}")
        with self._lock:
            self._refresh_locked()
            picked = self._pick_locked(metric, matchers)
        is_counter = counter_like(metric)
        series: List[Dict[str, Any]] = []
        for lk in sorted(picked):
            per = picked[lk]
            if fn == "raw":
                for proc in sorted(per):
                    pts = [[round(t, 3), v] for (t, _d, v) in per[proc]
                           if start_t <= t <= end_t]
                    if pts:
                        series.append({
                            "labels": dict(lk, proc=proc),
                            "points": pts})
                continue
            groups = ([(proc, {proc: arr}) for proc, arr in
                       sorted(per.items())] if by_proc else
                      [(None, per)])
            for proc, group in groups:
                labels = dict(lk) if proc is None else dict(lk,
                                                            proc=proc)
                if is_counter:
                    pts = self._counter_points(group, start_t, end_t,
                                               step, fn)
                else:
                    pts = self._gauge_points(group, start_t, end_t,
                                             step, fn)
                if pts is not None:
                    series.append({"labels": labels, "points": pts})
        return {
            "metric": metric, "kind": ("counter" if is_counter
                                       else "gauge"),
            "fn": fn, "start": round(start_t, 3),
            "end": round(end_t, 3), "step": step,
            "matchers": dict(matchers or {}),
            "series": series,
        }

    def _counter_points(self, group: Dict[str, List[Tuple[
            float, Optional[float], float]]], start_t: float,
            end_t: float, step: Optional[float], fn: str,
            ) -> Optional[List[List[float]]]:
        if not any(any(start_t < t <= end_t for (t, _d, _v) in arr)
                   for arr in group.values()):
            return None
        if step is None:
            inc = sum(self._increase(arr, start_t, end_t)
                      for arr in group.values())
            v = inc / (end_t - start_t) if fn == "rate" else inc
            return [[round(end_t, 3), v]]
        import math
        t0 = math.floor(start_t / step) * step   # grid alignment
        pts: List[List[float]] = []
        edge = t0
        while edge < end_t:
            lo, hi = edge, edge + step
            inc = sum(self._increase(arr, lo, hi)
                      for arr in group.values())
            v = inc / step if fn == "rate" else inc
            pts.append([round(hi, 3), v])
            edge = hi
        return pts

    @staticmethod
    def _gauge_points(group: Dict[str, List[Tuple[
            float, Optional[float], float]]], start_t: float,
            end_t: float, step: Optional[float], fn: str,
            ) -> Optional[List[List[float]]]:
        samples = sorted((t, v) for arr in group.values()
                         for (t, _d, v) in arr
                         if start_t <= t <= end_t)
        if not samples:
            return None
        delta = samples[-1][1] - samples[0][1]
        if fn == "rate":
            return [[round(end_t, 3), delta / (end_t - start_t)]]
        return [[round(end_t, 3), delta]]

    def window_increase(self, metric: str, start_t: float, end_t: float,
                        matchers: Optional[Dict[str, str]] = None,
                        ) -> float:
        """Total persisted increase of a counter family over a wall
        window, summed across all matching series and procs — the
        before/after evidence primitive the control ledger resolves
        outcomes from."""
        with self._lock:
            self._refresh_locked()
            picked = self._pick_locked(metric, matchers)
        return sum(self._increase(arr, start_t, end_t)
                   for per in picked.values() for arr in per.values())

    def top_series(self, k: int = 10, window_s: float = 300.0,
                   now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Top-K counter series by increase over the trailing window
        (``_total`` families only — bucket ladders would drown the
        signal)."""
        if now is None:
            now = _wall_now()
        start_t = now - max(1e-9, float(window_s))
        with self._lock:
            self._refresh_locked()
            snap = {key: {proc: list(arr) for proc, arr in per.items()}
                    for key, per in self._series.items()
                    if key[0].endswith("_total")}
        rows = []
        for (name, lk), per in snap.items():
            inc = sum(self._increase(arr, start_t, now)
                      for arr in per.values())
            if inc > 0:
                rows.append({
                    "name": name, "labels": dict(lk),
                    "increase": inc,
                    "rate": round(inc / float(window_s), 6),
                })
        # labels join the tie-break so equal-increase series render in
        # one deterministic order across procs and replays
        rows.sort(key=lambda r: (-r["increase"], r["name"],
                                 sorted(r["labels"].items())))
        return rows[:max(1, int(k))]

    # -- trend analysis ----------------------------------------------------

    def _window_pair(self, now: float, window_s: float,
                     ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        w = max(1e-9, float(window_s))
        return (now - 2 * w, now - w), (now - w, now)

    def trends(self, window_s: float = 300.0,
               now: Optional[float] = None,
               objectives: Optional[Any] = None) -> Dict[str, Any]:
        """Old-window vs new-window regression summary, computed purely
        from persisted deltas — this is what ``cluster_doc`` embeds
        under ``mrtpuCluster["history"]`` and ``obs/analysis`` turns
        into findings (so it survives restart and works offline on a
        saved cluster trace)."""
        if now is None:
            now = _wall_now()
        (o_lo, o_hi), (n_lo, n_hi) = self._window_pair(now, window_s)
        with self._lock:
            self._refresh_locked()
            snap = {key: {proc: list(arr) for proc, arr in per.items()}
                    for key, per in self._series.items()}
            offsets = {proc: list(h)
                       for proc, h in self._offset_hist.items()}
            entries, procs = self._entries, len(self._applied)
            oldest, newest = self._oldest_t, self._newest_t

        def fam_inc(name: str, lo: float, hi: float,
                    match: Optional[Dict[str, str]] = None) -> float:
            total = 0.0
            for (n, lk), per in snap.items():
                if n != name:
                    continue
                if match:
                    labels = dict(lk)
                    if any(labels.get(mk) != mv
                           for mk, mv in match.items()):
                        continue
                total += sum(self._increase(arr, lo, hi)
                             for arr in per.values())
            return total

        w = max(1e-9, float(window_s))
        rates = []
        for fam in TREND_RATE_FAMILIES:
            inc_old = fam_inc(fam, o_lo, o_hi)
            inc_new = fam_inc(fam, n_lo, n_hi)
            if inc_old == 0 and inc_new == 0:
                continue
            rates.append({
                "name": fam,
                "rate_old": round(inc_old / w, 6),
                "rate_new": round(inc_new / w, 6),
                "ratio": (round(inc_new / inc_old, 3)
                          if inc_old > 0 else None),
            })
        out: Dict[str, Any] = {
            "window_s": float(window_s), "t_end": round(now, 3),
            "entries": entries, "procs": procs,
            "span_s": (round(newest - oldest, 3)
                       if oldest is not None and newest is not None
                       else 0.0),
            "rates": rates,
        }
        cmp_old = fam_inc("mrtpu_device_seconds_total", o_lo, o_hi,
                          {"stage": "compute"})
        cmp_new = fam_inc("mrtpu_device_seconds_total", n_lo, n_hi,
                          {"stage": "compute"})
        wav_old = fam_inc("mrtpu_device_waves_total", o_lo, o_hi)
        wav_new = fam_inc("mrtpu_device_waves_total", n_lo, n_hi)
        if wav_old > 0 and wav_new > 0:
            spw_old = cmp_old / wav_old
            spw_new = cmp_new / wav_new
            out["compute_s_per_wave"] = {
                "old": round(spw_old, 6), "new": round(spw_new, 6),
                "ratio": (round(spw_new / spw_old, 3)
                          if spw_old > 0 else None),
            }
        jumps = {}
        for proc, hist in offsets.items():
            olds = [v for (t, v) in hist if o_lo < t <= o_hi]
            news = [v for (t, v) in hist if n_lo < t <= n_hi]
            if olds and news and abs(news[-1] - olds[-1]) >= \
                    OFFSET_JUMP_S:
                jumps[proc] = {"old": round(olds[-1], 6),
                               "new": round(news[-1], 6),
                               "jump_s": round(news[-1] - olds[-1], 6)}
        if jumps:
            out["offset_jumps"] = jumps
        out["burn"] = self._history_burn(snap, n_lo, n_hi, objectives)
        return out

    def _history_burn(self, snap: Dict[Tuple[str, LabelKey],
                                       Dict[str, List[Tuple[
                                           float, Optional[float],
                                           float]]]],
                      lo: float, hi: float,
                      objectives: Optional[Any]) -> List[Dict[str, Any]]:
        """Burn rates over REAL persisted windows: bucket deltas from
        history, not the in-memory deques that die with the process —
        the restart-proof half of the burn-rate alerts."""
        if objectives is None:
            from . import slo as _slo   # late: slo never imports us
            objectives = _slo.PLANE.objectives
        out: List[Dict[str, Any]] = []
        for obj in objectives:
            fam = obj.family + "_bucket"
            # per-tenant {le bound -> windowed count}
            per_tenant: Dict[str, Dict[float, float]] = {}
            for (name, lk), per in snap.items():
                if name != fam:
                    continue
                labels = dict(lk)
                le = labels.get("le")
                if le is None:
                    continue
                bound = float("inf") if le in ("+Inf", "inf") else \
                    float(le)
                tenant = labels.get("tenant", "-")
                inc = sum(self._increase(arr, lo, hi)
                          for arr in per.values())
                buckets = per_tenant.setdefault(tenant, {})
                buckets[bound] = buckets.get(bound, 0.0) + inc
            for tenant, buckets in sorted(per_tenant.items()):
                bounds = sorted(buckets)
                cum = [buckets[b] for b in bounds]
                counts = [cum[0]] + [cum[i] - cum[i - 1]
                                     for i in range(1, len(cum))]
                total = sum(counts)
                if total <= 0:
                    continue
                frac_ok = fraction_le(bounds, [max(0.0, c)
                                               for c in counts],
                                      obj.threshold_s)
                burn = (1.0 - frac_ok) / obj.budget
                out.append({
                    "objective": obj.name, "tenant": tenant,
                    "threshold_s": obj.threshold_s,
                    "window_n": int(total),
                    "burn": round(burn, 3),
                })
        return out

    # -- export / introspection --------------------------------------------

    def bucket_windows(self, family: str,
                       ) -> Dict[str, List[Tuple[float,
                                                 Dict[float, float]]]]:
        """Per-tenant cumulative bucket snapshots over time, merged
        across procs and other labels — the seed material
        :meth:`SloPlane.seed_from_history` rebuilds its windows from
        after a restart."""
        fam = family + "_bucket"
        with self._lock:
            self._refresh_locked()
            events: Dict[str, List[Tuple[float, Tuple[str, LabelKey,
                                                      str], float,
                                         float]]] = {}
            for (name, lk), per in self._series.items():
                if name != fam:
                    continue
                labels = dict(lk)
                le = labels.get("le")
                if le is None:
                    continue
                tenant = labels.get("tenant", "-")
                bound = (float("inf") if le in ("+Inf", "inf")
                         else float(le))
                for proc, arr in per.items():
                    for (t, _d, v) in arr:
                        events.setdefault(tenant, []).append(
                            (t, (name, lk, proc), bound, v))
        out: Dict[str, List[Tuple[float, Dict[float, float]]]] = {}
        for tenant, evs in events.items():
            evs.sort(key=lambda e: e[0])
            latest: Dict[Tuple[Any, float], float] = {}
            snaps: List[Tuple[float, Dict[float, float]]] = []
            for (t, skey, bound, v) in evs:
                latest[(skey, bound)] = v
                merged: Dict[float, float] = {}
                for (_sk, b), val in latest.items():
                    merged[b] = merged.get(b, 0.0) + val
                snaps.append((t, merged))
            out[tenant] = snaps
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The /statusz history row."""
        with self._lock:
            n_segs, n_bytes = self._disk_stats_locked()
            return {
                "dir": self.dir,
                "segments": n_segs,
                "bytes": n_bytes,
                "entries": self._entries,
                "rotations": self._rotations,
                "gc_segments": self._gc_segments,
                "series": len(self._series),
                "procs": len(self._applied),
                "oldest_t": (round(self._oldest_t, 3)
                             if self._oldest_t is not None else None),
                "newest_t": (round(self._newest_t, 3)
                             if self._newest_t is not None else None),
                "keep_segments": self.keep_segments,
                "max_segment_bytes": self.max_segment_bytes,
                "max_segment_age_s": self.max_segment_age_s,
            }

    def segment_paths(self) -> List[str]:
        with self._lock:
            return [os.path.join(self.dir, n)
                    for n in self._segment_files()]

    def copy_segments(self, dst_dir: str) -> List[str]:
        """Validated copy of every segment into *dst_dir* (the profile
        bundle's ``history/`` artifact) — each copy is re-read through
        :func:`validate_history` after landing, the same
        write-then-reload discipline every other bundle artifact gets."""
        os.makedirs(dst_dir, exist_ok=True)
        copied: List[str] = []
        for src in self.segment_paths():
            dst = os.path.join(dst_dir, os.path.basename(src))
            shutil.copyfile(src, dst)
            _read_segment(dst, 0)   # raises HistoryCorruptError
            copied.append(dst)
        return copied

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None
                self._writer_name = None


def note_error(kind: str) -> None:
    """Count a swallowed history-plane error (the collector keeps
    accepting telemetry when history append fails — telemetry can
    degrade, jobs cannot — but the failure must be visible)."""
    _ERRORS.inc(kind=kind)


def read_history(directory: str) -> Dict[str, Any]:
    """Read-only load of a segment directory (bundle reload path): no
    write fds, every entry validated; raises
    :class:`HistoryCorruptError` loudly on garbage."""
    entries = 0
    procs: Dict[str, int] = {}
    series = set()
    oldest: Optional[float] = None
    newest: Optional[float] = None
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith(SEGMENT_PREFIX)
                   and n.endswith(SEGMENT_SUFFIX))
    for name in names:
        segs, _off = _read_segment(os.path.join(directory, name), 0)
        for e in segs:
            entries += 1
            procs[e["proc"]] = max(procs.get(e["proc"], 0),
                                   int(e["seq"]))
            t = float(e["t"])
            oldest = t if oldest is None else min(oldest, t)
            newest = t if newest is None else max(newest, t)
            for row in e["s"]:
                series.add((row[0], tuple(sorted(row[1].items()))))
    return {
        "segments": len(names), "entries": entries,
        "procs": {p: s for p, s in sorted(procs.items())},
        "series": len(series),
        "oldest_t": oldest, "newest_t": newest,
    }
