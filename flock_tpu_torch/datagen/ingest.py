"""External-source ingestion: trigger-event parsing + live fragment streams —
the port of ``flock_tpu/datagen/ingest.py``.

Reference counterpart: flock/src/datasource/kafka.rs:91-110 and
kinesis.rs:89-115 — a Lambda trigger event carries base64 record payloads;
the source decodes them, newline-joins, infers the schema from the first
record, and parses line-delimited JSON into batches.  The live transport
here replaces Lambda trigger delivery with two host analogues:

* ``FileTailSource`` — tails an append-only JSONL fragment log (the
  at-least-once broker analogue; works for replay and for a producer
  appending concurrently).
* ``SocketIngestServer`` + ``send_fragments`` — newline-delimited JSON
  fragments over TCP.

Fragments may arrive out of order and duplicated.  ``EpochAssembler`` routes
them through the window ``Arena`` (runtime/arena.py — bitmap reassembly,
exactly the reference aggregator's posture, arena/mod.rs:60-233) and
releases complete epochs in stream order; ``IngestDriver`` feeds those to
the windowed StreamDriver on its device (the card unless ``device="cpu"``;
with no device and no CUDA it raises before it reads a line).

Fragment wire format (one JSON object per line):

    {"qid": str, "epoch": int, "seq": int, "seq_len": int,
     "relation": "bid"|"person"|"auction", "rows": [<reference event JSON>]}

``rows`` uses the reference generator's serde_json row format
(event.rs:314-324), so a fragment stream produced from reference-format
event dumps replays through this path unchanged.
"""

from __future__ import annotations

import base64
import json
import socket
import socketserver
import threading
import time
from dataclasses import dataclass

import numpy as np

from flock_tpu_torch import resolve_device
from flock_tpu_torch.datagen.sources import (
    parse_auction_lines,
    parse_bid_lines,
    parse_person_lines,
)
from flock_tpu_torch.runtime.arena import Arena, WindowStatus
from flock_tpu_torch.runtime.payload import FragmentId, Payload

_PARSERS = {"bid": parse_bid_lines, "person": parse_person_lines,
            "auction": parse_auction_lines}

_RELATION_KEYS = {
    frozenset(("auction", "bidder", "price", "b_date_time")): "bid",
    frozenset(("p_id", "name", "email_address", "credit_card", "city",
               "state", "p_date_time")): "person",
    frozenset(("a_id", "item_name", "description", "initial_bid", "reserve",
               "a_date_time", "expires", "seller", "category")): "auction",
}


def infer_relation(first_row: dict) -> str:
    """Schema inference from the first record (the infer_json_schema
    analogue, kafka.rs:100-103): known NEXMark relations are keyed by their
    column sets; anything else infers a generic columnar schema."""
    return _RELATION_KEYS.get(frozenset(first_row.keys()), "generic")


def parse_generic_lines(lines) -> dict[str, np.ndarray]:
    """Line-JSON → columnar with inferred dtypes (the Arrow
    infer_json_schema + json::Reader analogue, kafka.rs:100-110): all-int →
    int64, numeric → float64, otherwise string (object array; the engine
    dictionary-encodes strings at the plan boundary)."""
    rows = [json.loads(l) for l in lines if l.strip()]
    keys = list(rows[0].keys()) if rows else []
    out = {}
    for k in keys:
        vals = [r[k] for r in rows]
        if all(isinstance(v, bool) for v in vals):
            out[k] = np.array(vals, np.bool_)
        elif all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
            out[k] = np.array(vals, np.int64)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in vals):
            out[k] = np.array(vals, np.float64)
        else:
            out[k] = np.array(vals, object)
    return out


def _parse_lines(lines: list[str]) -> tuple[str, dict[str, np.ndarray]]:
    rel = infer_relation(json.loads(lines[0]))
    parser = _PARSERS.get(rel, parse_generic_lines)
    return rel, parser(lines)


def kafka_event_to_columns(event: dict) -> tuple[str, dict[str, np.ndarray]]:
    """Kafka Lambda trigger event → (relation, columnar batch).

    Mirrors kafka.rs:91-110: every topic-partition's records are base64
    value payloads; decode all, newline-join, parse as line JSON with the
    schema inferred from the first record.  Fixture:
    tests/golden_ref/example-kafka-event.json (the reference's own test
    event, flock/src/tests/data/)."""
    lines: list[str] = []
    for records in event["records"].values():
        for r in records:
            if r.get("value") is not None:
                lines.append(base64.b64decode(r["value"]).decode())
    if not lines:
        raise ValueError("kafka event carries no record values")
    return _parse_lines(lines)


def kinesis_event_to_columns(event: dict) -> tuple[str, dict[str, np.ndarray]]:
    """Kinesis Lambda trigger event → (relation, columnar batch)
    (kinesis.rs:89-115; records[i].kinesis.data is base64)."""
    lines = [base64.b64decode(r["kinesis"]["data"]).decode()
             for r in event["Records"]]
    if not lines:
        raise ValueError("kinesis event carries no records")
    return _parse_lines(lines)


# -- fragment stream ----------------------------------------------------------


def _reference_row(rel: str, cols: dict, j: int) -> dict:
    """One columnar row → the reference generator's serde_json shape
    (event.rs:130-149,220-245,336-352): dictionary codes decode back to the
    vocab strings so the wire format matches what the reference emits."""
    from flock_tpu_torch.datagen.nexmark import (FIRST_NAMES, LAST_NAMES,
                                                 US_CITIES, US_STATES)

    row = {k: (v[j].item() if hasattr(v[j], "item") else v[j])
           for k, v in cols.items()}
    if rel == "person":
        code = row["name"]
        row["name"] = (f"{FIRST_NAMES[code // len(LAST_NAMES)]} "
                       f"{LAST_NAMES[code % len(LAST_NAMES)]}")
        row["city"] = US_CITIES[row["city"]]
        row["state"] = US_STATES[row["state"]]
    return row


def fragment_lines(epochs: list[dict], qid: str, granule: int = 1024,
                   relations: tuple[str, ...] = ("bid",)) -> list[str]:
    """Producer side: chop per-epoch relation tables into granule-sized
    fragment lines (the reference's payload granule slicing, flock.toml:59-61).
    Each (epoch, relation) window is seq_len fragments; epochs with no rows
    emit one empty fragment so consumers can close the window (the negative-
    seq empty-payload marker analogue, state/s3.rs:108-186)."""
    out = []
    for t, tables in enumerate(epochs):
        for rel in relations:
            cols = tables.get(rel) or {}
            n = len(next(iter(cols.values()))) if cols else 0
            seq_len = max(1, -(-n // granule))
            for i in range(seq_len):
                sl = slice(i * granule, min((i + 1) * granule, n))
                rows = [_reference_row(rel, cols, j)
                        for j in range(sl.start, sl.stop)] if n else []
                out.append(json.dumps({
                    "qid": qid, "epoch": t, "seq": i, "seq_len": seq_len,
                    "relation": rel, "rows": rows,
                }))
    return out


class EpochAssembler:
    """Routes fragment lines through the Arena; releases complete epochs in
    stream order (epoch t is released only once epochs 0..t are all
    complete, preserving windowed-query semantics under out-of-order
    arrival)."""

    def __init__(self, qid: str, relations: tuple[str, ...],
                 n_epochs: int):
        self.qid = qid
        self.relations = relations
        self.n_epochs = n_epochs
        self.arena = Arena()
        self._complete: dict[int, dict] = {}   # epoch → relation tables
        self._pending: dict[int, dict] = {}    # epoch → {rel: columns}
        self._next = 0

    def _wid(self, epoch: int, rel: str):
        return (f"{self.qid}/{rel}", epoch)

    def feed(self, line: str) -> list[tuple[int, dict]]:
        """Feed one fragment line; returns newly releasable (epoch, tables)
        pairs in order."""
        f = json.loads(line)
        rel = f["relation"]
        rows = f["rows"]
        if rows:
            cols = _PARSERS[rel]([json.dumps(r) for r in rows])
        else:
            cols = {}
        payload = Payload(
            FragmentId(f"{self.qid}/{rel}", f["seq"], f["seq_len"],
                       shuffle_id=f["epoch"]),
            cols, metadata={"relation": rel, "epoch": f["epoch"]})
        status = self.arena.collect(payload)
        if status is WindowStatus.READY:
            tables = self.arena.take(self._wid(f["epoch"], rel))
            self._pending.setdefault(f["epoch"], {})[rel] = tables
        return self._drain()

    def _drain(self) -> list[tuple[int, dict]]:
        released = []
        while self._next < self.n_epochs:
            got = self._pending.get(self._next)
            if got is None or set(got) != set(self.relations):
                break
            released.append((self._next, got))
            del self._pending[self._next]
            self._next += 1
        return released

    @property
    def done(self) -> bool:
        return self._next >= self.n_epochs


def _empty_tables(relations: tuple[str, ...]) -> dict:
    # column skeletons come from the parsers on an empty line set
    return {rel: _PARSERS[rel]([]) for rel in relations}


@dataclass
class IngestDriver:
    """ingest → arena → windowed query: the actor's collect→execute loop
    (actor.rs:99-123) over an external fragment stream.  ``device`` is the
    ``StreamDriver``'s (None → the card)."""

    spec: object
    seconds: int
    qid: str = "ingest"
    side_input: dict | None = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def run(self, lines) -> list:
        from flock_tpu_torch.runtime.stream import StreamDriver

        rels = tuple(r for r in self.spec.relations if r != "side_input")
        asm = EpochAssembler(self.qid, rels, self.seconds)
        epochs: list[dict] = []
        for line in lines:
            for _t, tables in asm.feed(line):
                # arena.take returns {} for empty windows → column skeletons
                full = _empty_tables(rels)
                full.update({r: c for r, c in tables.items() if c})
                epochs.append(full)
        if not asm.done:
            missing = {t: sorted(set(rels) - set(asm._pending.get(t, {})))
                       for t in range(asm._next, asm.n_epochs)}
            raise ValueError(f"fragment stream incomplete: {missing}")
        driver = StreamDriver(self.spec, self.seconds,
                              side_input=self.side_input, device=self.device)
        return driver.run(epochs)


# -- live transports ----------------------------------------------------------


@dataclass
class FileTailSource:
    """Tail an append-only JSONL fragment log until ``n_lines`` lines arrive
    (replay and live-producer cases both work)."""

    path: str
    n_lines: int
    poll_s: float = 0.02
    timeout_s: float = 30.0

    def __iter__(self):
        got = 0
        buf = ""
        deadline = time.monotonic() + self.timeout_s
        with open(self.path) as f:
            while got < self.n_lines:
                chunk = f.read()
                if chunk:
                    buf += chunk
                    while "\n" in buf:
                        line, buf = buf.split("\n", 1)
                        if line.strip():
                            got += 1
                            yield line
                else:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"tail: {got}/{self.n_lines} lines before timeout")
                    time.sleep(self.poll_s)


class SocketIngestServer:
    """TCP ingest endpoint: producers connect and send newline-delimited
    fragment JSON; ``lines()`` yields them as they arrive."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lines: list[str] = []
        self._cv = threading.Condition()
        self._closed = False
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.decode().strip()
                    if not line:
                        continue
                    with outer._cv:
                        outer._lines.append(line)
                        outer._cv.notify_all()

        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.server_address

    def lines(self, n: int, timeout_s: float = 30.0):
        """Yield the first n received fragment lines (blocking)."""
        i = 0
        deadline = time.monotonic() + timeout_s
        while i < n:
            with self._cv:
                while len(self._lines) <= i:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        raise TimeoutError(f"socket ingest: {i}/{n} lines")
                    self._cv.wait(min(rem, 0.5))
                line = self._lines[i]
            i += 1
            yield line

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def send_fragments(address: tuple[str, int], lines,
                   max_retries: int = 20) -> None:
    """Producer: stream fragment lines to a SocketIngestServer.

    Transient connect/send failures reconnect with the reference's
    linear-random backoff (aws/lambda.rs:104-152) and resend from a rewound
    position — at-least-once delivery; the consumer's arena drops duplicate
    fragments (runtime/arena.py).  ``sendall`` returning only means the bytes
    were queued in the kernel socket buffer, not delivered, so on any
    connection error the cursor rewinds past every line that could still
    have been in flight (a socket buffer holds ~256 KB ≈ a few thousand
    fragment lines; the rewind is sized from the observed line lengths)."""
    from flock_tpu_torch.utils.retry import with_retry

    lines = list(lines)
    sent = 0
    SOCKET_BUFFER_BYTES = 1 << 20  # requested SO_SNDBUF; over-rewinding is safe

    def attempt() -> None:
        nonlocal sent
        # TCP keeps data in the send buffer until ACKed, so the bytes that can
        # be queued-but-undelivered at a disconnect are bounded by the send
        # buffer size — but ONLY if it is pinned: Linux tcp_wmem autotuning
        # grows unpinned buffers to 4-6 MB, past any static rewind bound.
        # Pin SO_SNDBUF before connect (disables autotune for this socket)
        # and size the rewind from what the kernel actually granted
        # (getsockopt reports the doubled, bookkeeping-inclusive value).
        snd_bound = 2 * SOCKET_BUFFER_BYTES
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                             SOCKET_BUFFER_BYTES)
                snd_bound = max(snd_bound,
                                s.getsockopt(socket.SOL_SOCKET,
                                             socket.SO_SNDBUF))
                s.settimeout(30)
                s.connect(address)
                while sent < len(lines):
                    s.sendall(lines[sent].encode() + b"\n")
                    sent += 1
        except OSError:
            # rewind past everything that may have been queued-but-undelivered
            rewound = 0
            while sent > 0 and rewound < snd_bound:
                sent -= 1
                rewound += len(lines[sent]) + 1
            raise

    with_retry(attempt, max_retries=max_retries, retryable=(OSError,))
