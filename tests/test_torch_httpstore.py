"""The port's blob service (``mapreduce_tpu_torch.storage.httpstore``)
against the JAX package's.

The blob protocol and its gzip negotiation are the JAX package's, so one
script over {port, JAX} ``HttpStorage`` x {port, JAX} ``BlobServer``,
with the server's gzip on and off, must store the same bytes, read the
same bytes back and count the same raw and wire bytes as the JAX pair.
The script's main blob is text records of float gradients, the way
``examples/train_digits`` moves them.  The http cases of
``tests/test_storage.py`` are mirrored on the port's pair.  Every server
binds port 0 and is shut down by its test.
"""

import os

import numpy as np
import pytest

from mapreduce_tpu.obs.metrics import REGISTRY as JREG
from mapreduce_tpu.storage import httpstore as jhs
from mapreduce_tpu.utils.serialization import serialize_record as jser
from mapreduce_tpu_torch.obs.metrics import REGISTRY as TREG
from mapreduce_tpu_torch.storage import httpstore as ths
from mapreduce_tpu_torch.storage.httpstore import BlobServer, HttpStorage
from mapreduce_tpu_torch.storage.router import get_storage_from
from mapreduce_tpu_torch.utils.serialization import serialize_record

PKGS = {"port": (ths, TREG), "jax": (jhs, JREG)}
XFER = [(d, e) for d in ("put", "get") for e in ("gzip", "identity")]


def _grad_records(seed=0):
    """train_digits' map output: one record per weight matrix, the
    gradients as a float list plus the row count."""
    rng = np.random.default_rng(seed)
    lines = [serialize_record(name, [rng.standard_normal(shape).tolist(),
                                     64])
             for name, shape in (("b0", (16,)), ("w0", (32, 16)),
                                 ("w1", (16, 10)))]
    lines.append(serialize_record("TR_LOSS", [2.302585, 64]))
    return lines


def _counts(reg):
    return {(d, e): (reg.value("mrtpu_blob_raw_bytes_total", direction=d,
                               encoding=e),
                     reg.value("mrtpu_blob_wire_bytes_total", direction=d,
                               encoding=e)) for d, e in XFER}


def _blob_script(client_pkg, server_pkg, gzip_on, root):
    cmod, reg = PKGS[client_pkg]
    smod, _ = PKGS[server_pkg]
    srv = smod.BlobServer(str(root), port=0,
                          gzip_enabled=gzip_on).start_background()
    try:
        st = cmod.HttpStorage(srv.address, compress=True)
        st.LINES_CHUNK = 1024  # several Range GETs per blob
        before = _counts(reg)
        lines = _grad_records()
        text = "\n".join(lines) + "\n"
        out = []
        st.write("probe", "x\n")           # the negotiation's one probe
        st.write("grads/map.P00001.M0", text)
        st.write("small", "tiny\n")        # under GZIP_MIN_BYTES
        st.write_bytes("bin/shard.npy", bytes(range(256)) * 8)
        b = st.builder()
        for ln in lines:
            b.write_record_line(ln)
        b.build("grads/built")
        out.append(st.read("grads/map.P00001.M0") == text)
        out.append(list(st.open_lines("grads/built")) == lines)
        out.append(st.read_bytes("bin/shard.npy"))
        out.append(st.list())
        out.append(st.list(r"^grads/"))
        out.append((st.exists("small"), st.exists("nope")))
        with pytest.raises(FileNotFoundError):
            st.read("nope")
        stored = {n: open(os.path.join(str(root), n), "rb").read()
                  for n in sorted(os.listdir(str(root)))
                  if not n.startswith(".")}
        st.remove("small")
        st.remove("small")  # idempotent
        out.append(st.list())
        after = _counts(reg)
        deltas = {k: (after[k][0] - before[k][0],
                      after[k][1] - before[k][1]) for k in XFER}
        st.clear()
        out.append(st.list())
        st.close()
        return out, stored, deltas
    finally:
        srv.shutdown()


@pytest.mark.parametrize("gzip_on", [True, False], ids=["gzip", "identity"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_cross_wire_blobs(client_pkg, server_pkg, gzip_on, tmp_path):
    """Equal bytes stored and read, equal raw/wire counts, for every
    pairing, as the JAX pair gives them."""
    got = _blob_script(client_pkg, server_pkg, gzip_on, tmp_path / "a")
    want = _blob_script("jax", "jax", gzip_on, tmp_path / "b")
    assert got == want
    out, stored, deltas = got
    assert out[0] and out[1]
    assert stored["grads%2Fmap.P00001.M0"] == (
        "\n".join(_grad_records()) + "\n").encode()
    raw_put = deltas[("put", "gzip")][0] + deltas[("put", "identity")][0]
    assert raw_put == sum(len(v) for v in stored.values())
    if gzip_on:
        # the probe and the small blob go identity, the rest gzipped
        raw, wire = deltas[("put", "gzip")]
        assert raw > 0 and wire < raw
        assert deltas[("put", "identity")][0] == len("x\ntiny\n")
    else:
        assert deltas[("put", "gzip")] == (0, 0)
        assert deltas[("get", "gzip")] == (0, 0)


def test_train_digits_records_match_the_jax_serializer():
    """The gradient records the port writes are the JAX package's."""
    rng = np.random.default_rng(1)
    rec = ("w0", [rng.standard_normal((4, 3)).tolist(), 64])
    assert serialize_record(*rec) == jser(*rec)


@pytest.fixture
def store(tmp_path):
    srv = BlobServer(str(tmp_path / "served"), port=0).start_background()
    st = HttpStorage(srv.address)
    yield st
    st.close()
    srv.shutdown()


def test_builder_publish_read(store):
    b = store.builder()
    b.write_record_line("('a', [1])")
    b.write_record_line("('b', [2, 3])")
    assert not store.exists("f1")  # nothing visible pre-build
    b.build("f1")
    assert store.exists("f1")
    assert list(store.open_lines("f1")) == ["('a', [1])", "('b', [2, 3])"]


def test_list_patterns_and_remove(store):
    for name in ("path/map_results.P00001.M3", "path/map_results.P00002.M3",
                 "result.P00001", "other"):
        store.write(name, "x\n")
    assert store.list(r"\.P\d+\.M") == [
        "path/map_results.P00001.M3", "path/map_results.P00002.M3"]
    assert store.list(r"^result\.P\d+$") == ["result.P00001"]
    store.remove("other")
    assert not store.exists("other")
    store.clear()
    assert store.list() == []


def test_overwrite_and_odd_names(store):
    store.write("f", "one\n")
    store.write("f", "two\n")
    assert store.read("f") == "two\n"
    for name in ("p/map_results.P00001.Mwe%20ird'key", "line\nbreak"):
        store.write(name, "v\n")
        assert store.exists(name)
        assert name in store.list()


def test_http_open_lines_streams_bounded(tmp_path):
    """A multi-MB blob is read through http in Range-GET slices, never as
    one body: per-request transfer stays <= LINES_CHUNK."""
    srv = BlobServer(str(tmp_path / "served"), port=0).start_background()
    try:
        st = HttpStorage(srv.address)
        st.LINES_CHUNK = 4096
        lines = [f"word{i} " * 8 for i in range(4000)]
        lines[1234] = "x" * 20000  # one line longer than the slice size
        st.write("big", "\n".join(lines) + "\n")
        sizes = []
        orig = st._request

        def spy(method, path, body=None, headers=None):
            status, data = orig(method, path, body=body, headers=headers)
            if method == "GET" and headers and "Range" in headers:
                sizes.append(len(data))
            return status, data

        st._request = spy
        assert list(st.open_lines("big")) == lines
        assert len(sizes) > 10 and max(sizes) <= 4096
        st.close()
    finally:
        srv.shutdown()


def test_gzip_refusal_renegotiates_to_identity(tmp_path):
    """A server that stopped speaking gzip after the client negotiated it
    answers 415; the client forgets the advert and re-sends identity."""
    srv = BlobServer(str(tmp_path / "served"), port=0).start_background()
    try:
        st = HttpStorage(srv.address, compress=True)
        st.write("a", "x\n")                 # probe: learns the advert
        st.write("b", "y" * 4096)            # gzipped
        srv.httpd.RequestHandlerClass.gzip_enabled = False
        st.write("c", "z" * 4096)            # 415, then identity
        assert st._server_gzip is False
        assert st.read("c") == "z" * 4096
        st.close()
    finally:
        srv.shutdown()


def test_storage_dsl():
    assert get_storage_from("http:127.0.0.1:8750") == ("http",
                                                       "127.0.0.1:8750")
    with pytest.raises(ValueError):
        get_storage_from("http")  # needs HOST:PORT
    with pytest.raises(ValueError):
        HttpStorage("nohostport")
