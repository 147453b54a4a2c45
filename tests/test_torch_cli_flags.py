"""Every flag of every JAX command against the port's CLI.

Each JAX command's option strings are read from its ``--help`` text, and
so are the port's for the same command: every JAX flag must be one of
the port's, or the command must be named in ``NOT_PORTED_COMMANDS``.
Then ``wordcount --device --segment-impl ... --tokenize-impl ...`` runs
on the CPU: its stdout equals the JAX CLI's on the same file, and the
two flags reach the example's init args as the JAX CLI passes them.
``drain`` (the last command ported) takes the JAX flags, and the same
drains on a ``dir://`` board print the same lines and exit with the same
codes in both packages.
"""

import contextlib
import io
import re
import threading

import pytest

import mapreduce_tpu.examples.wordcount as jwc
from mapreduce_tpu import cli as jcli
from mapreduce_tpu import spec as jspec

import mapreduce_tpu_torch.examples.wordcount as twc
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import server as tserver
from mapreduce_tpu_torch import spec as tspec

#: seconds a CLI run may take here before the test fails
RUN_TIMEOUT = 60
_FLAG = re.compile(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)")


def _help_flags(main, cmd):
    """The option strings in ``main([cmd, "--help"])``'s output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit) as exc:
        main([cmd, "--help"])
    assert exc.value.code == 0, cmd
    return set(_FLAG.findall(out.getvalue())) - {"--help"}


def _jax_commands():
    return sorted(jcli.COMMANDS)


def test_jax_has_nineteen_commands():
    assert len(_jax_commands()) == 19


@pytest.mark.parametrize("cmd", _jax_commands())
def test_every_jax_flag_is_in_the_port(cmd):
    want = _help_flags(jcli.main, cmd)
    assert want, cmd
    if cmd in tcli.NOT_PORTED_COMMANDS:
        return
    got = _help_flags(tcli.main, cmd)
    missing = sorted(want - got)
    assert not missing, f"{cmd}: the port's parser lacks {missing}"


@pytest.fixture(autouse=True)
def fresh_modules():
    def reset():
        jspec.clear_caches()
        tspec.clear_caches()
        for mod in (jwc, twc):
            mod._conf.clear()
            mod._conf.update({"files": [], "num_reducers": 15})
            mod.RESULT.clear()
    reset()
    yield
    reset()


def _run(main, argv):
    """``main(argv)`` in a thread joined under a timeout; (stdout,
    stderr)."""
    out, err = io.StringIO(), io.StringIO()
    box = {}

    def target():
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            box["rc"] = main(argv)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(RUN_TIMEOUT)
    assert not t.is_alive(), f"{argv} still running after {RUN_TIMEOUT} s"
    assert box["rc"] == 0, err.getvalue()
    return out.getvalue(), err.getvalue()


@pytest.fixture
def corpus(tmp_path):
    words = ["the", "fox", "über", "a,b", "日本", "it's"] + [
        f"w{i}" for i in range(40)]
    lines = [" ".join(words[(i * 7 + j) % len(words)] for j in range(i % 9))
             for i in range(120)]
    p = tmp_path / "f.txt"
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_wordcount_takes_segment_and_tokenize_impl(corpus, impl,
                                                   monkeypatch):
    jout, _ = _run(jcli.main, ["wordcount", corpus, "--workers", "2",
                               "--no-autotune", "--no-speculative-reclaim",
                               "--no-compile-cache"])
    seen = []
    configure = tserver.Server.configure

    def spy(self, params):
        seen.append(dict(params["init_args"]))
        return configure(self, params)

    monkeypatch.setattr(tserver.Server, "configure", spy)
    tout, _ = _run(tcli.main, ["wordcount", "--device", "--segment-impl",
                               impl, "--tokenize-impl", impl,
                               "--torch-device", "cpu", corpus])
    assert tout == jout
    assert seen and seen[0]["device_segment_impl"] == impl
    assert seen[0]["device_tokenize_impl"] == impl


def test_impl_flags_without_device_warn_as_in_jax(corpus):
    _, jerr = _run(jcli.main, ["wordcount", corpus, "--workers", "2",
                               "--segment-impl", "lax", "--no-autotune",
                               "--no-speculative-reclaim",
                               "--no-compile-cache"])
    tspec.clear_caches()
    _, terr = _run(tcli.main, ["wordcount", corpus, "--workers", "2",
                               "--segment-impl", "lax"])
    warning = ("WARNING: --sort-impl/--segment-impl/--tokenize-impl only "
               "affect the device engine (--device); the host path "
               "ignores them")
    assert warning in jerr and warning in terr


# -- drain --------------------------------------------------------------------


def test_drain_takes_the_jax_flags():
    flags = _help_flags(tcli.main, "drain")
    assert flags == _help_flags(jcli.main, "drain")
    assert {"--timeout", "--auth", "--retry-attempts",
            "--breaker-cooldown", "--verbose"} <= flags
    assert "drain" in tcli.COMMANDS and not tcli.NOT_PORTED_COMMANDS


def _drain(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["drain", *argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", ["unknown_host", "rehome", "no_live"])
def test_drain_runs_as_in_jax(tmp_path, case):
    """The same board state, then ``drain --timeout 0.3``: equal exit
    codes, stdout and stderr from both packages (a host that never steps
    down is re-homed anyway after the timeout)."""
    from mapreduce_tpu.coord import docstore as jdocstore
    from mapreduce_tpu.coord import fleet as jfleet
    from mapreduce_tpu_torch.coord import docstore as tdocstore
    from mapreduce_tpu_torch.coord import fleet as tfleet

    got = {}
    for name, main, docstore, fleet in (
            ("jax", jcli.main, jdocstore, jfleet),
            ("port", tcli.main, tdocstore, tfleet)):
        board = tmp_path / name
        board.mkdir()
        store = docstore.connect(f"dir://{board}")
        if case != "unknown_host":
            fleet.FleetMember(store, host_id="hostA").join(timeout=5.0)
            if case == "rehome":
                fleet.FleetMember(store, host_id="hostB").join(
                    timeout=5.0, warm_programs=["wc"], hbm_frac=0.2)
            fleet.FleetRegistry(store).assign("t", "hostA",
                                              program="wc")
        got[name] = _drain(main, [f"dir://{board}", "hostA",
                                  "--timeout", "0.3"])
        if case == "rehome":
            assert fleet.FleetRegistry(store).route("t")["host"] == "hostB"
    assert got["port"] == got["jax"]
    rc = got["port"][0]
    assert rc == {"unknown_host": 2, "rehome": 0, "no_live": 1}[case]
