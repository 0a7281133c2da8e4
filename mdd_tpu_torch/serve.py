"""Persistent serving loop for single-word MDD diagnosis (counterpart of
mdd_tpu/serve.py): the line-delimited JSON protocol over a stream pair
(`serve_loop`, stdin / stdout) or over a TCP or unix socket with
concurrent clients and batching across them (`SocketServer`, the CLI's
`serve --socket ADDR`).

The engine and the lexicon load once and answer many requests:

  request:  {"wav": "/path/to.wav", "word": "about"}
            optional: "id" (echoed), "canonical" (a non-empty list of
            model units that overrides the lexicon's phones for the word,
            the analogue of the demo's TextGrid prompts)
  response: {"status": "ok", "id": ..., "word": ..., "score": ...,
             "correct": ..., "total": ...,
             "canonical_row": ..., "ops_row": ..., "decoded_row": ...,
             "insertion_faults": [...], "substitution_faults": [...],
             "deletion_faults": [...], "ipa": ..., "translation": ...,
             "phonics": ..., "seconds": <group wall>,
             "amortized_seconds": <seconds / batch>, "batch": <size>}
  errors:   {"status": "error", "id": ..., "error": "..."}

"ipa" is the lexicon's 英/美 display, "translation" the ECDICT entry and
"phonics" the letter-group breakdown ("" where the dictionaries have
none).  One response line per request line, in order; EOF shuts down.
Requests that are already queued are answered together (up to
`max_batch`), in batched forwards bucketed by length, so a diagnosis never
depends on what arrived with it.  "seconds" is the wall clock a request
waited (its whole group's processing time); "amortized_seconds" its share.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import json
import os
import queue
import socket
import stat
import threading
import time
from typing import IO

from mdd_tpu_torch.infer import InferenceEngine


def _diag_response(diag, rid, seconds: float, batch: int) -> dict:
    d = dataclasses.asdict(diag)
    return {
        "status": "ok",
        "id": rid,
        "word": diag.word,
        "score": diag.score,
        "correct": diag.correct,
        "total": diag.total,
        "canonical_row": d["canonical_row"],
        "ops_row": d["ops_row"],
        "decoded_row": d["decoded_row"],
        "insertion_faults": d["insertion_faults"],
        "substitution_faults": d["substitution_faults"],
        "deletion_faults": d["deletion_faults"],
        "ipa": diag.ipa_display,
        "translation": diag.translation,
        "phonics": diag.phonics,
        # seconds: the wall clock this request waited (its whole group's
        # processing time); amortized_seconds: its share of that work
        "seconds": round(seconds, 4),
        "amortized_seconds": round(seconds / max(batch, 1), 4),
        "batch": batch,
    }


def _request_error(req: dict) -> str | None:
    wav_path, word = req.get("wav"), req.get("word")
    if (not wav_path or not word or not isinstance(wav_path, str)
            or not isinstance(word, str)):
        return "request needs string 'wav' and 'word'"
    canonical = req.get("canonical")
    if canonical is not None and (
            not isinstance(canonical, list) or not canonical
            or not all(isinstance(p, str) for p in canonical)):
        return "'canonical', when given, must be a non-empty list of strings"
    return None


def handle_requests(engine: InferenceEngine, lines: list) -> list:
    """A group of JSON request lines -> responses, in order.

    Valid requests share batched forwards (engine.diagnose_words);
    malformed or failing requests get per-request error responses without
    disturbing the rest."""
    t0 = time.time()
    resps: list = [None] * len(lines)
    items, slots = [], []
    for i, line in enumerate(lines):
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resps[i] = {"status": "error", "error": f"bad json: {e}"}
            continue
        if not isinstance(req, dict):
            resps[i] = {"status": "error", "error": "request must be an object"}
            continue
        rid = req.get("id")
        if (err := _request_error(req)) is not None:
            resps[i] = {"status": "error", "id": rid, "error": err}
            continue
        try:
            wav = engine._prepare_audio(req["wav"])
        except FileNotFoundError as e:
            resps[i] = {"status": "error", "id": rid, "error": str(e)}
            continue
        except Exception as e:  # noqa: BLE001 — one unreadable file
            # must not fail the group
            resps[i] = {"status": "error", "id": rid,
                        "error": f"{type(e).__name__}: {e}"}
            continue
        if wav is None:
            resps[i] = {"status": "error", "id": rid,
                        "error": "audio exceeds the maximum length gate"}
            continue
        # unique utt id per slot so same-word requests don't collide
        items.append((f"r{i}", wav, req["word"], req.get("canonical")))
        slots.append((i, rid))
    if items:
        try:
            diags = engine.diagnose_words(items)
            seconds = time.time() - t0
            for (i, rid), diag in zip(slots, diags):
                resps[i] = _diag_response(diag, rid, seconds, len(items))
        except Exception:  # noqa: BLE001 — one bad item must not fail the
            # group: retry each request singly so only the offender errors
            for (i, rid), item in zip(slots, items):
                t1 = time.time()
                try:
                    diag = engine.diagnose_words([item])[0]
                    resps[i] = _diag_response(diag, rid, time.time() - t1, 1)
                except Exception as e:  # noqa: BLE001
                    resps[i] = {"status": "error", "id": rid,
                                "error": f"{type(e).__name__}: {e}"}
    return resps


def handle_request(engine: InferenceEngine, line: str) -> dict:
    """One JSON request line -> one JSON-serializable response dict."""
    return handle_requests(engine, [line])[0]


def serve_loop(engine: InferenceEngine, in_stream: IO[str],
               out_stream: IO[str], log=None, max_batch: int = 16) -> int:
    """Serve until EOF; returns the number of requests handled.

    A reader thread moves complete lines into a queue; requests already
    queued when one is picked up are handled together (up to
    `max_batch`; the default is the top of the engine's BATCH_SIZES
    ladder)."""
    q: "queue.Queue" = queue.Queue()
    eof = object()

    def reader() -> None:
        try:
            for line in in_stream:
                if line.strip():
                    q.put(line.strip())
        finally:
            q.put(eof)

    threading.Thread(target=reader, daemon=True).start()
    n = 0
    done = False
    while not done:
        item = q.get()
        if item is eof:
            break
        group = [item]
        while len(group) < max_batch:
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is eof:
                done = True
                break
            group.append(nxt)
        for resp in handle_requests(engine, group):
            out_stream.write(json.dumps(resp, ensure_ascii=False) + "\n")
            n += 1
            if log is not None:
                log(f"[serve] #{n} {resp.get('word', '?')} -> "
                    f"{resp['status']} ({resp.get('seconds', 0)}s, "
                    f"batch {len(group)})")
        out_stream.flush()
    return n


class _Connection:
    """One client of a SocketServer: its socket, a bounded outbox of
    encoded response lines and the writer thread that drains it, so that
    no other thread ever blocks on this client's socket.  The writer closes
    the connection once the client has stopped sending (`eof`) and every
    request it sent was answered."""

    def __init__(self, sock: socket.socket, outbox_max: int, on_sent):
        self.sock = sock
        self.outbox: "queue.Queue" = queue.Queue(maxsize=outbox_max)
        self.closed = threading.Event()
        self.eof = False       # the reader met the end of the client's lines
        self.pending = 0       # requests queued and not yet answered
        self.lock = threading.Lock()
        self._on_sent = on_sent
        self.writer = threading.Thread(target=self._write, daemon=True)
        self.writer.start()

    def send(self, data: bytes) -> bool:
        """Queue one response without blocking; False, and the connection
        closed, when it is closed already or its outbox is full."""
        with self.lock:
            self.pending -= 1
        if self.closed.is_set():
            return False
        try:
            self.outbox.put_nowait(data)
        except queue.Full:
            self.close()
            return False
        return True

    def done(self) -> bool:
        with self.lock:
            return self.eof and self.pending == 0 and self.outbox.empty()

    def _write(self) -> None:
        while not self.closed.is_set():
            try:
                data = self.outbox.get(timeout=0.1)
            except queue.Empty:
                if self.done():
                    self.close()
                continue
            try:
                self.sock.sendall(data)
            except OSError:
                self.close()
                return
            finally:
                self.outbox.task_done()
            self._on_sent()

    def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        try:
            # wakes a writer blocked in sendall and a reader in recv
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _loopback_host(host: str) -> str:
    """The host of a TCP bind, which must be a loopback address: the
    protocol names files on the server, so it must not face a network."""
    host = host or "127.0.0.1"
    if host == "localhost":
        return "127.0.0.1"
    try:
        loopback = ipaddress.ip_address(host).is_loopback
    except ValueError:
        loopback = False
    if not loopback:
        raise ValueError(
            f"refusing to listen on {host!r}: requests name files on this "
            "machine, so the socket server binds only a loopback address "
            "(127.0.0.1, localhost) or a unix-socket path")
    return host


class SocketServer:
    """TCP / unix-socket transport around the serve protocol.

    The line-delimited JSON contract of `serve_loop`, over a listening
    socket with any number of concurrent clients.  A reader thread a
    connection puts complete lines on one shared FIFO; the batcher thread
    (`serve_forever`) answers whatever is pending, up to `max_batch`, in
    one `handle_requests` call and hands each response to its connection's
    writer thread through a bounded outbox: batching across clients, and
    per-connection answers in request order.  The batcher never blocks on
    a socket: a connection whose outbox overflows (a client that stopped
    reading) is dropped and counted in `n_dropped`.

    `address` is "host:port" for TCP, where the host must be a loopback
    address ("host:0" binds an ephemeral port, kept in `.port`), or a
    filesystem path for a unix socket.  `serve_forever()` returns after
    `shutdown()`, once the queued requests are answered: it closes the live
    connections and unlinks the unix-socket path.  `n_served` counts the
    responses delivered to a client's socket.  `sndbuf` sets SO_SNDBUF on
    each connection (None: the system's)."""

    #: shared-queue bound: readers wait when the engine falls behind
    QUEUE_MAX = 1024
    #: responses waiting for one client's writer; past it the client is
    #: dropped
    OUTBOX_MAX = 256

    def __init__(self, engine: InferenceEngine, address: str,
                 max_batch: int = 16, log=None, outbox_max: int | None = None,
                 sndbuf: int | None = None):
        self.engine = engine
        self.max_batch = max_batch
        self.log = log
        self.outbox_max = outbox_max or self.OUTBOX_MAX
        self.sndbuf = sndbuf
        self.q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._shutdown = threading.Event()
        self._conns: set = set()
        self._lock = threading.Lock()
        self.n_served = 0
        self.n_dropped = 0
        # a path (a separator, or no colon at all) is a unix socket;
        # otherwise host:port
        if os.sep in address or ":" not in address:
            if os.path.exists(address):
                if not stat.S_ISSOCK(os.stat(address).st_mode):
                    raise ValueError(
                        f"refusing to replace non-socket file {address!r}")
                os.unlink(address)
            self.path = address
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.bind(address)
            self.port = None
        else:
            host, port = address.rsplit(":", 1)
            host = _loopback_host(host)
            self.path = None
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind((host, int(port)))
            self.port = self.sock.getsockname()[1]
        self.sock.listen(64)
        self.sock.settimeout(0.2)   # so the accept loop sees shutdown

    def _sent(self) -> None:
        with self._lock:
            self.n_served += 1

    def _reader(self, conn: _Connection) -> None:
        """Complete lines of one client -> the shared queue."""
        try:
            with conn.sock.makefile("r", encoding="utf-8",
                                    errors="replace") as f:
                for line in f:
                    if not line.strip():
                        continue
                    with conn.lock:
                        conn.pending += 1
                    while not self._shutdown.is_set():
                        try:
                            self.q.put((conn, line.strip()), timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    else:
                        return
        except (OSError, ValueError):
            pass  # closed under us; its queued requests still run
        finally:
            with conn.lock:
                conn.eof = True

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self.sndbuf:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sndbuf)
            conn = _Connection(sock, self.outbox_max, self._sent)
            with self._lock:
                self._conns = {c for c in self._conns
                               if not c.closed.is_set()} | {conn}
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _route(self, conn: _Connection, resp: dict, batch: int) -> None:
        data = (json.dumps(resp, ensure_ascii=False) + "\n").encode()
        was_open = not conn.closed.is_set()
        if not conn.send(data) and was_open:
            with self._lock:
                self.n_dropped += 1
        if self.log is not None:
            self.log(f"[serve] {resp.get('word', '?')} -> {resp['status']} "
                     f"(batch {batch})")

    def serve_forever(self) -> int:
        """Accept and answer until shutdown(); returns n_served."""
        accept = threading.Thread(target=self._accept_loop, daemon=True)
        accept.start()
        try:
            while True:
                try:
                    item = self.q.get(timeout=0.2)
                except queue.Empty:
                    if self._shutdown.is_set():
                        break
                    continue
                group = [item]
                while len(group) < self.max_batch:
                    try:
                        group.append(self.q.get_nowait())
                    except queue.Empty:
                        break
                conns, lines = zip(*group)
                for conn, resp in zip(conns,
                                      handle_requests(self.engine,
                                                      list(lines))):
                    self._route(conn, resp, len(group))
        finally:
            self._shutdown.set()
            self.sock.close()
            accept.join(timeout=5)
            self._close_connections()
            if self.path is not None and os.path.exists(self.path):
                os.unlink(self.path)
        return self.n_served

    def _close_connections(self, drain_s: float = 2.0) -> None:
        """Let each writer deliver what is queued (up to drain_s in all),
        then close every connection."""
        deadline = time.monotonic() + drain_s
        with self._lock:
            conns = list(self._conns)
            self._conns = set()
        for conn in conns:
            while (not conn.closed.is_set() and conn.outbox.unfinished_tasks
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            conn.close()
            conn.writer.join(timeout=max(0.0, deadline - time.monotonic())
                             + 0.5)

    def shutdown(self) -> None:
        """Stop accepting; serve_forever answers what is queued, closes the
        connections and returns."""
        self._shutdown.set()
