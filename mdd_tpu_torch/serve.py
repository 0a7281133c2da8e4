"""Persistent serving loop for single-word MDD diagnosis (counterpart of
mdd_tpu/serve.py: the line-delimited JSON protocol over a stream pair).

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
The socket transport of mdd_tpu (`SocketServer`) is not in the port yet.
"""

from __future__ import annotations

import dataclasses
import json
import queue
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
