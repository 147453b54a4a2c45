"""The port's remaining examples against the JAX package's.

* ``examples/wordspan``: ``[count, first, last]`` a word through the
  port's ``Server(device=True)`` on ``Partitions(1, "cpu")`` and
  ``Partitions(8, "cpu")`` (the latter on the radix path), with
  capacities small enough that the engine retries, held equal to the JAX
  ``Server(device=True)`` run (its ``lax`` formulations, as
  ``tests/test_device_path.py`` runs it), the port's host plane and a
  regex oracle over the concatenated stream.
* ``examples/wordcountbig``: the glob ``taskfn`` against the JAX
  module, as ``tests/test_cli.py`` runs it.
* ``native``: the port's ``g++`` library against its Python twin and
  both against the JAX package's ``native.wordcount_bytes``, over seeded
  random bytes (non-UTF-8 bytes, empty input, whitespace only, more
  uniques than the library's first capacity).
* ``examples/wordcount_native`` through ``Server`` against the JAX
  module's ``RESULT``.

Inputs come from ``numpy.random.default_rng`` with a fixed seed; every
comparison is exact (integer results).  Every ``Server.loop`` runs in a
thread joined under a timeout.
"""

import re
import threading
import uuid
from collections import Counter

import numpy as np
import pytest

import mapreduce_tpu.examples.wordcountbig as jbig
import mapreduce_tpu.examples.wordcount_native as jnat
import mapreduce_tpu.examples.wordspan as jws
from mapreduce_tpu import native as jnative
from mapreduce_tpu import spec as jspec
from mapreduce_tpu.server import Server as JServer
from mapreduce_tpu.worker import spawn_worker_threads as jspawn

import mapreduce_tpu_torch.examples.wordcount as twc
import mapreduce_tpu_torch.examples.wordcount_native as tnat
import mapreduce_tpu_torch.examples.wordspan as tws
from mapreduce_tpu_torch import native as tnative
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.examples import naive
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.server import Server as TServer
from mapreduce_tpu_torch.storage.router import router as trouter
from mapreduce_tpu_torch.utils import compile_cache
from mapreduce_tpu_torch.worker import spawn_worker_threads as tspawn

#: seconds a whole loop may take here before the test fails
LOOP_TIMEOUT = 120
JWS = "mapreduce_tpu.examples.wordspan"
TWS = "mapreduce_tpu_torch.examples.wordspan"
#: the port's capacities for wordspan: the corpus's ~1,500 uniques
#: overflow them, so the engine retries
SMALL_CAPS = {"device_local_capacity": 1 << 9,
              "device_exchange_capacity": 1 << 6,
              "device_out_capacity": 1 << 9}
#: the JAX run's: no retry (each retry is a new XLA compile here)
JAX_CAPS = {"device_local_capacity": 1 << 12,
            "device_exchange_capacity": 1 << 11,
            "device_out_capacity": 1 << 12}


def _reset():
    jspec.clear_caches()
    tspec.clear_caches()
    for mod, conf in ((jws, {"files": [], "num_reducers": 8}),
                      (tws, {"files": [], "num_reducers": 8}),
                      (twc, {"files": [], "num_reducers": 15}),
                      (jnat, {"blobs": [], "num_reducers": 15,
                              "storage": None}),
                      (tnat, {"blobs": [], "num_reducers": 15,
                              "storage": None})):
        mod._conf.clear()
        mod._conf.update(conf)
        mod.RESULT.clear()
    jbig._big_conf.update({"glob": None})
    jnat._handle = tnat._handle = None


@pytest.fixture(autouse=True)
def fresh_modules():
    _reset()
    yield
    _reset()


def _in_thread(fn, timeout=LOOP_TIMEOUT):
    """Run *fn* in a daemon thread, fail if it outlives *timeout*, and
    re-raise what it raised."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised in the test thread
            box["err"] = exc

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _run(Server, spawn, params, workers=0, db="ex"):
    """One task through *Server* with *workers* worker threads; the
    stats doc and the server."""
    connstr = f"mem://{uuid.uuid4().hex}"
    threads = spawn(connstr, db, workers) if workers else []
    server = Server(connstr, db)
    server.configure(params)
    stats = _in_thread(server.loop)
    for t in threads:
        t.join(timeout=LOOP_TIMEOUT)
        assert not t.is_alive(), f"worker {t.name} did not exit"
    return stats, server


def _roles(module):
    params = {r: module for r in ("taskfn", "mapfn", "partitionfn",
                                  "reducefn", "finalfn")}
    params["combinerfn"] = module
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    return params


# -- wordspan ------------------------------------------------------------------


@pytest.fixture(scope="module")
def span_corpus(tmp_path_factory):
    """Three files of whole lines over a ~1,500-word vocabulary (with
    UTF-8 words), and the regex oracle over their ``\\n``-join."""
    root = tmp_path_factory.mktemp("span")
    rng = np.random.default_rng(7)
    vocab = ["über", "naïve", "日本", "it's"] + [
        f"w{i}" for i in range(1500)]
    files = []
    for f in range(3):
        lines = []
        for _ in range(120):
            n = int(rng.integers(0, 25))
            lines.append(" ".join(vocab[int(i)] for i in
                                  rng.integers(0, len(vocab), n)))
        p = root / f"s{f}.txt"
        p.write_text("\n".join(lines) + "\n", encoding="utf-8")
        files.append(str(p))
    stream = b"\n".join(open(f, "rb").read() for f in files)
    oracle = {}
    for m in re.finditer(rb"\S+", stream):
        k = m.group().decode()
        got = oracle.get(k)
        if got is None:
            oracle[k] = [1, m.start(), m.start()]
        else:
            got[0] += 1
            got[2] = m.start()
    return files, oracle


def _span_params(module, files, device=False, caps=SMALL_CAPS, **extra):
    params = _roles(module)
    params["init_args"] = {"files": files, "num_reducers": 4,
                           "device_chunk_len": 2048, **caps, **extra}
    if device:
        params["device"] = True
    return params


@pytest.fixture(scope="module")
def jax_span(span_corpus):
    """The JAX ``Server(device=True)`` wordspan run (its callable monoid
    on the 8-device CPU mesh)."""
    files, _ = span_corpus
    _reset()
    _run(JServer, jspawn, _span_params(JWS, files, device=True,
                                       caps=JAX_CAPS))
    out = dict(jws.RESULT)
    _reset()
    return out


@pytest.fixture(scope="module")
def host_span(span_corpus):
    """The port's host plane (2 worker threads)."""
    files, _ = span_corpus
    _reset()
    _run(TServer, tspawn, _span_params(TWS, files), workers=2)
    out = dict(tws.RESULT)
    _reset()
    return out


@pytest.mark.parametrize("n,sort_impl", [(1, "variadic"), (8, "radix")])
def test_wordspan_device_equals_jax_host_and_oracle(
        span_corpus, jax_span, host_span, n, sort_impl):
    files, oracle = span_corpus
    params = _span_params(TWS, files, device=True,
                          device_sort_impl=sort_impl)
    params["partitions"] = Partitions(n, "cpu")
    kc.reset_counts()
    stats, _ = _run(TServer, tspawn, params)
    got = dict(tws.RESULT)
    assert stats["device"]["retries"] >= 1  # the small capacities retried
    assert got == oracle
    assert got == jax_span
    assert got == host_span
    # the 3-lane reduce went through the segmented reduce (its plain
    # version here), and at P = 8 the radix path
    assert kc.PLAIN_CALLS["segreduce"] > 0
    assert kc.PLAIN_CALLS["tokenize"] > 0
    if sort_impl == "radix":
        assert kc.PLAIN_CALLS["radix_plan"] > 0
        assert kc.PLAIN_CALLS["radix_onesweep"] > 0


def test_wordspan_device_config_is_per_lane_codes():
    """The JAX monoid is a callable; the port's is its per-lane codes,
    which the CUDA kernel takes (a callable raises there: ROADMAP A.9)."""
    cfg = tws.device_config()
    assert cfg.reduce_op == ("sum", "min", "max")
    assert callable(jws.device_config().reduce_op)
    assert (cfg.local_capacity, cfg.exchange_capacity, cfg.out_capacity,
            cfg.tile, cfg.tile_records) == (
        1 << 15, 1 << 13, 1 << 15, 512, 128)


def test_wordspan_map_keeps_padding_out_of_min_and_max():
    """Invalid rows carry INT32_MAX in the min lane and -1 in the max
    lane, through tile_compact's padding."""
    import torch

    chunk = torch.from_numpy(np.frombuffer(
        b"ab cd ab" + b" " * 1016, dtype=np.uint8).copy())
    cfg = tws.device_config()
    keys, values, payload, valid, oflow = tws.device_map(chunk, 3, cfg)
    assert int(oflow) == 0 and int(valid.sum()) == 3
    v = values[valid].tolist()
    assert [r[1] for r in v] == [3 * 1024, 3 * 1024 + 3, 3 * 1024 + 6]
    assert all(r[0] == 1 and r[1] == r[2] for r in v)
    pad = values[~valid]
    assert (pad[:, 0] == 0).all() and (pad[:, 1] == 2 ** 31 - 1).all()
    assert (pad[:, 2] == -1).all()


def test_wordspan_refuses_an_int32_overflowing_stream(tmp_path,
                                                      monkeypatch):
    """Offsets are int32 on the device: a padded stream past 2**31 bytes
    is refused by name, never wrapped (a small bound stands in for it)."""
    p = tmp_path / "a.txt"
    p.write_text("some words here\n" * 200)
    tws.init({"files": [str(p)], "device_chunk_len": 1024})
    monkeypatch.setattr(tws, "MAX_STREAM_BYTES", 2048)
    with pytest.raises(AssertionError, match="int32"):
        tws.device_prepare([("0000", str(p))], Partitions(1, "cpu"))


# -- wordcountbig --------------------------------------------------------------


def test_wordcountbig_glob_equals_jax(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"split-{i:03d}.txt"
        p.write_text(f"big corpus split {i} words words\n" * 4)
        files.append(str(p))
    (tmp_path / "notmatched.dat").write_text("excluded tokens\n")
    init = {"glob": str(tmp_path / "split-*.txt"), "num_reducers": 4}
    results = {}
    for name, Server, spawn, mod in (
            ("jax", JServer, jspawn, "mapreduce_tpu.examples.wordcountbig"),
            ("port", TServer, tspawn,
             "mapreduce_tpu_torch.examples.wordcountbig")):
        params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                                   "reducefn", "finalfn")}
        params["storage"] = f"mem:{uuid.uuid4().hex}"
        params["init_args"] = init
        stats, _ = _run(Server, spawn, params, workers=2, db="big")
        assert stats["map"]["count"] == 3, name
        results[name] = dict(
            __import__(mod, fromlist=["RESULT"]).RESULT)
    assert results["port"] == results["jax"] == naive.wordcount(files)
    assert "excluded" not in results["port"]


# -- the native host core ------------------------------------------------------


def _random_bytes(seed, n_words, vocab, junk=False):
    rng = np.random.default_rng(seed)
    words = [f"v{i}".encode() for i in range(vocab)]
    if junk:  # non-UTF-8 bytes inside and between words
        words += [b"\xff\xfe", b"a\x80b", b"\xc3"]
    seps = [b" ", b"\n", b"\t", b"  ", b"\r\n", b"\x0b", b"\x0c"]
    out = []
    for i in rng.integers(0, len(words), n_words):
        out.append(words[int(i)])
        out.append(seps[int(rng.integers(0, len(seps)))])
    return b"".join(out)


NATIVE_CASES = {
    "empty": b"",
    "whitespace_only": b" \t\n\r\x0b\x0c  \n",
    "one_word": b"word",
    "utf8_and_junk": _random_bytes(1, 5000, 300, junk=True),
    # more uniques than the library's first capacity (1<<17): it regrows
    "over_capacity": b" ".join(f"u{i}".encode()
                               for i in range((1 << 17) + 5000)),
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_library_equals_twin_and_jax(case):
    data = NATIVE_CASES[case]
    want = Counter(data.split())
    lib = tnative.wordcount_bytes(data)
    assert lib == want
    assert tnative.wordcount_bytes_py(data) == want
    assert jnative.wordcount_bytes(data) == lib
    # the records themselves: hash, first offset, length, count per word
    hs, st, ln, ct = tnative.tokenize_count(data)
    ph, ps, pl, pc = tnative.tokenize_count_py(data)
    assert (sorted(zip(hs.tolist(), st.tolist(), ln.tolist(), ct.tolist()))
            == sorted(zip(ph.tolist(), ps.tolist(), pl.tolist(),
                          pc.tolist())))


def test_native_fnv_batch_equals_twin_and_jax():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (500, 24), dtype=np.uint8)
    lengths = rng.integers(0, 25, 500).astype(np.int32)
    got = tnative.fnv1a32_batch(tokens, lengths)
    assert np.array_equal(got, tnative.fnv1a32_batch_py(tokens, lengths))
    assert np.array_equal(got, jnative.fnv1a32_batch(tokens, lengths))


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    """No quiet fallback: a source g++ refuses raises, naming its
    output."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(compile_cache, "build_dir",
                        lambda: str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*bad.cpp"):
        tnative.load_library()


# -- wordcount_native through Server -------------------------------------------


def test_wordcount_native_server_equals_jax(tmp_path):
    rng = np.random.default_rng(11)
    blobs = {f"split-{i}": " ".join(
        f"w{int(x)}" for x in rng.integers(0, 900, 3000)) + "\n"
        for i in range(4)}
    results = {}
    for name, Server, spawn, mod, store in (
            ("jax", JServer, jspawn,
             "mapreduce_tpu.examples.wordcount_native", tmp_path / "j"),
            ("port", TServer, tspawn,
             "mapreduce_tpu_torch.examples.wordcount_native",
             tmp_path / "t")):
        dsl = f"shared:{store}"
        st = trouter(dsl)
        for blob, text in blobs.items():
            st.write(blob, text)
        params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                                   "reducefn", "finalfn", "combinerfn")}
        params["storage"] = dsl
        params["init_args"] = {"blobs": sorted(blobs), "num_reducers": 4,
                               "storage": dsl}
        stats, _ = _run(Server, spawn, params, workers=2, db="nat")
        assert stats["map"]["count"] == 4, name
        results[name] = dict(
            __import__(mod, fromlist=["RESULT"]).RESULT)
    want = Counter(w for t in blobs.values() for w in t.split())
    assert results["port"] == results["jax"] == dict(want)
