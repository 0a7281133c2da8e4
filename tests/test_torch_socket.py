"""The port's socket server and the denoise default, on the CPU at a small
width (the tiny model and the dictionary of tests/test_torch_infer.py):
concurrent TCP clients whose co-batched answers equal each request's solo
answer; a unix socket with a bad JSON line answered by an error; a TCP
bind to a non-loopback host refused; a client that never reads (its
SO_SNDBUF shrunk, its outbox bound small) dropped without delaying
another client; shutdown closing the connections and unlinking the path;
and `serve --socket` and `infer` with its default `--denoise` through the
CLI on `--device cpu`, the latter against mdd_tpu's engine with
`denoiser=mdd_tpu.native.spectral_denoise`.

Every socket read, accept and thread join has its own timeout, so that a
hang fails the test instead of stalling the run."""

import contextlib
import json
import socket
import threading
import time

import pytest

import mdd_tpu.native as jax_native
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.frontend.cmvn import parse_kaldi_cmvn_text as jax_parse_cmvn
from mdd_tpu.infer import InferenceEngine as JaxEngine
from mdd_tpu.lexicon.dictionary import Phonetic as JaxPhonetic
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu_torch import cli, native
from mdd_tpu_torch import serve as port_serve
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
from mdd_tpu_torch.infer import InferenceEngine
from mdd_tpu_torch.lexicon.dictionary import Phonetic
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.serve import SocketServer, handle_requests
from test_torch_infer import (CFG, UNITS, WORDS, _conf, _FIELDS,  # noqa: F401
                              _split_logs, world)
from test_torch_native import jax_libs  # noqa: F401

TIMEOUT = 30.0   # any one socket read, accept or join
SOLO_FIELDS = [k for k in _FIELDS if k != "batch"]


@pytest.fixture(scope="module")
def engine(world):
    return InferenceEngine(
        ModelConfig(**CFG), world["state"], Vocab(UNITS),
        parse_kaldi_cmvn_text(world["cmvn"]),
        phonetic=Phonetic(world["asset_dir"], world["ecdict"]),
        device="cpu")


@contextlib.contextmanager
def serving(engine, address, **kw):
    server = SocketServer(engine, address, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive(), "serve_forever did not return"


def connect(server, address=None):
    if server.port is not None:
        return socket.create_connection(("127.0.0.1", server.port),
                                        timeout=TIMEOUT)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(TIMEOUT)
    s.connect(address)
    return s


def exchange(sock, lines):
    """Send every line, then read one response line each."""
    sock.sendall(("\n".join(lines) + "\n").encode())
    f = sock.makefile("r", encoding="utf-8")
    return [json.loads(f.readline()) for _ in lines]


def requests(world, tag, n):
    paths = world["paths"]
    return [json.dumps({"id": f"{tag}{k}", "wav": paths[k % len(paths)],
                        "word": WORDS[k % len(WORDS)]}) for k in range(n)]


def same_as_solo(engine, lines, resps):
    for line, resp in zip(lines, resps):
        (solo,) = handle_requests(engine, [line])
        assert {k: resp.get(k) for k in SOLO_FIELDS} == {
            k: solo.get(k) for k in SOLO_FIELDS}


def test_concurrent_tcp_clients_are_batched_and_match_solo(world, engine):
    per_client = {c: requests(world, f"c{c}-", 6) for c in range(3)}
    got = {}

    def client(c):
        with connect(server) as s:
            got[c] = exchange(s, per_client[c])

    with serving(engine, "127.0.0.1:0", max_batch=8) as server:
        assert server.port > 0
        threads = [threading.Thread(target=client, args=(c,))
                   for c in per_client]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    assert sorted(got) == [0, 1, 2]
    for c, resps in got.items():
        assert [r["status"] for r in resps] == ["ok"] * 6
        assert [r["id"] for r in resps] == [f"c{c}-{k}" for k in range(6)]
        assert max(r["batch"] for r in resps) <= 8
        same_as_solo(engine, per_client[c], resps)
    assert max(r["batch"] for rs in got.values() for r in rs) > 1
    assert server.n_served == 18 and server.n_dropped == 0


def test_many_clients_under_fast_thread_switching_lose_no_answer(engine):
    """More client threads than cores, and the interpreter switching
    threads every microsecond: every answer arrives, in order, and
    n_served counts each one (a lost update of a shared counter or of a
    connection's pending count would break one of these)."""
    import sys

    n_clients, n_lines = 12, 5
    got = {}

    def client(c):
        with connect(server) as s:
            got[c] = exchange(s, [json.dumps({"id": f"{c}-{k}"})
                                  for k in range(n_lines)])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with serving(engine, "127.0.0.1:0", max_batch=4) as server:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
                assert not t.is_alive()
            deadline = time.monotonic() + TIMEOUT
            while (server.n_served < n_clients * n_lines
                   and time.monotonic() < deadline):
                time.sleep(0.01)
    finally:
        sys.setswitchinterval(interval)
    assert server.n_served == n_clients * n_lines
    for c in range(n_clients):
        assert [r["id"] for r in got[c]] == [f"{c}-{k}"
                                             for k in range(n_lines)]
        assert {r["status"] for r in got[c]} == {"error"}


def test_unix_socket_answers_bad_lines_with_errors(world, engine, tmp_path):
    path = str(tmp_path / "s.sock")
    lines = ["{not json", json.dumps({"id": "no-word", "wav": "x.wav"}),
             requests(world, "u", 1)[0]]
    with serving(engine, path, max_batch=4) as server:
        assert server.port is None
        with connect(server, path) as s:
            resps = exchange(s, lines)
    assert resps[0]["status"] == "error" and "bad json" in resps[0]["error"]
    assert resps[1] == {"status": "error", "id": "no-word",
                        "error": "request needs string 'wav' and 'word'"}
    assert resps[2]["status"] == "ok" and resps[2]["id"] == "u0"


@pytest.mark.parametrize("address", ["0.0.0.0:0", "10.0.0.7:0",
                                     "example.com:0", "[::]:0", "::1x:0"])
def test_non_loopback_bind_is_refused(engine, address):
    with pytest.raises(ValueError, match="loopback"):
        SocketServer(engine, address)


@pytest.mark.parametrize("address", ["127.0.0.1:0", "localhost:0", ":0"])
def test_loopback_binds_are_taken(engine, address):
    server = SocketServer(engine, address)
    try:
        assert server.port > 0
        assert server.sock.getsockname()[0] == "127.0.0.1"
    finally:
        server.sock.close()


def test_client_that_stops_reading_does_not_stall_another(world, engine):
    """The stalled client floods requests whose error answers are long and
    reads none: its socket buffers fill, its writer blocks, its outbox of 4
    overflows and it is dropped.  Meanwhile the other client's answers
    arrive within 2 s each."""
    flood = [json.dumps({"id": k, "wav": "/nonexistent/" + "x" * 2000,
                         "word": "about"}) for k in range(400)]
    with serving(engine, "127.0.0.1:0", max_batch=16, outbox_max=4,
                 sndbuf=4096) as server:
        stalled = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        stalled.settimeout(TIMEOUT)
        stalled.connect(("127.0.0.1", server.port))

        def send_flood():
            with contextlib.suppress(OSError):   # dropped while sending
                stalled.sendall(("\n".join(flood) + "\n").encode())

        sender = threading.Thread(target=send_flood)
        sender.start()
        with connect(server) as good:
            f = good.makefile("rw", encoding="utf-8")
            waits = []
            for line in requests(world, "g", 4):
                t0 = time.perf_counter()
                f.write(line + "\n")
                f.flush()
                resp = json.loads(f.readline())
                waits.append(time.perf_counter() - t0)
                assert resp["status"] == "ok"
        deadline = time.monotonic() + TIMEOUT
        while server.n_dropped == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.n_dropped == 1
        sender.join(timeout=TIMEOUT)
        stalled.close()
    assert max(waits) < 2.0, waits
    assert server.n_served < 4 + len(flood)   # only delivered ones count


def test_shutdown_closes_connections_and_unlinks_the_path(world, engine,
                                                          tmp_path):
    path = tmp_path / "down.sock"
    with serving(engine, str(path)) as server:
        client = connect(server, str(path))
        assert exchange(client, requests(world, "d", 1))[0]["status"] == "ok"
        assert path.exists()
    # serving() has shut the server down and joined it
    assert client.recv(1) == b""        # the server closed our connection
    client.close()
    assert not path.exists()
    assert server.n_served == 1


@pytest.fixture
def recorded_servers(monkeypatch):
    """SocketServers that the CLI builds, kept for the test to stop."""
    made = []

    class Recorded(SocketServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(port_serve, "SocketServer", Recorded)
    return made


def test_serve_socket_subcommand_denoises_by_default(world, tmp_path, capsys,
                                                     recorded_servers):
    """`serve --socket PATH --device cpu`: the answers of an engine with
    the port's denoiser, request for request."""
    path = str(tmp_path / "cli.sock")
    argv = ["serve", "--conf", _conf(world), "--checkpoint",
            str(world["root"] / "ckpt"), "--cmvn", world["cmvn"],
            "--dict-dir", world["asset_dir"], "--ecdict-csv", world["ecdict"],
            "--socket", path, "--max-batch", "4", "--device", "cpu",
            "--quiet"]
    rc = []
    thread = threading.Thread(target=lambda: rc.append(cli.main(argv)),
                              daemon=True)
    thread.start()
    deadline = time.monotonic() + TIMEOUT
    while not recorded_servers and time.monotonic() < deadline:
        time.sleep(0.05)
    (server,) = recorded_servers
    lines = requests(world, "cli", 6)
    try:
        with connect(server, path) as s:
            resps = exchange(s, lines)
    finally:
        server.shutdown()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and rc == [0]
    err = capsys.readouterr().err
    assert f"ready on {path}" in err
    assert "served 6 requests in " in err
    denoised = InferenceEngine(
        ModelConfig(**CFG), world["state"], Vocab(UNITS),
        parse_kaldi_cmvn_text(world["cmvn"]),
        phonetic=Phonetic(world["asset_dir"], world["ecdict"]),
        device="cpu", denoiser=native.spectral_denoise)
    assert [r["status"] for r in resps] == ["ok"] * 6
    same_as_solo(denoised, lines, resps)


def test_infer_denoises_by_default_as_mdd_tpu(world, jax_libs, tmp_path,
                                              capsys):
    """`infer --device cpu` (denoise on by default) prints the reports
    that mdd_tpu's engine logs with its native denoiser, and differs from
    `--no-denoise` where the denoiser moves a decode."""
    reports = {}
    for flag in ("--denoise", "--no-denoise"):
        assert cli.main([
            "infer", "--wav-transcript-path", str(world["wav_dir"]),
            "--conf", _conf(world), "--checkpoint",
            str(world["root"] / "ckpt"), "--cmvn", world["cmvn"],
            "--dict-dir", world["asset_dir"], "--ecdict-csv",
            world["ecdict"], "--decode-dump", str(tmp_path / f"{flag}.txt"),
            flag, "--device", "cpu"]) == 0
        reports[flag] = _split_logs([capsys.readouterr().out])
    jax_engine = JaxEngine(
        JaxConfig(**CFG), world["variables"], JaxVocab(UNITS),
        jax_parse_cmvn(world["cmvn"]),
        phonetic=JaxPhonetic(world["asset_dir"], world["ecdict"]),
        denoiser=jax_native.spectral_denoise)
    ref_log = []
    jax_engine.diagnose_dir(str(world["wav_dir"]), log=ref_log.append,
                            decode_dump=str(tmp_path / "ref.txt"))
    assert reports["--denoise"][0] == _split_logs(ref_log)[0]
    assert len(reports["--denoise"][1]) == 3
    assert (tmp_path / "--denoise.txt").read_text() == (
        tmp_path / "ref.txt").read_text()
    assert reports["--denoise"][0] != reports["--no-denoise"][0]
