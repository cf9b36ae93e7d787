"""External stream ingestion in the port (``flock_tpu_torch.datagen.ingest``)
against flock_tpu's: the fragment lines byte for byte, and the rows of the
port's ``IngestDriver`` on the same scrambled, duplicated fragment lines as
the reference's ``IngestDriver``/``StreamDriver`` — out-of-order q2, q3
over two relations, q4 (K1's plain path under ingest), the socket and
file-tail transports, the kafka and kinesis trigger events, the producer's
reconnect, the file backend's write retry (tests/test_ingest.py's tests,
on the port) (PyTorch port, CPU)."""

import base64
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from flock_tpu.datagen import ingest as ref_ingest
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.stream import StreamDriver as RefStreamDriver
from flock_tpu.runtime.stream import generate_epochs as ref_generate_epochs
from flock_tpu_torch.datagen.ingest import (
    EpochAssembler,
    FileTailSource,
    IngestDriver,
    SocketIngestServer,
    fragment_lines,
    infer_relation,
    kafka_event_to_columns,
    kinesis_event_to_columns,
    parse_generic_lines,
    send_fragments,
)
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs

torch.set_num_threads(1)

SECONDS = 6
EPS = 800
# the reference's socket and file deadlines (tests/test_ingest.py)
LINES_TIMEOUT_S, DEADLINE_S = 60, 120
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ref")


@pytest.fixture(scope="module")
def epochs():
    return generate_epochs(SECONDS, EPS, 2)


@pytest.fixture(scope="module")
def ref_epochs():
    return ref_generate_epochs(SECONDS, EPS, 2)


def rows(cols, names):
    arrays = [np.asarray(cols[n]) for n in names]
    if not len(arrays[0]):
        return []
    return sorted(zip(*(a.tolist() for a in arrays)))


def all_rows(results, names):
    return sorted(r for res in results for r in rows(res.columns, names))


def scrambled(lines, seed=7, dup=5):
    """Out-of-order + duplicated delivery (tests/test_ingest.py's)."""
    rng = random.Random(seed)
    out = list(lines)
    rng.shuffle(out)
    for _ in range(dup):
        out.insert(rng.randrange(len(out) + 1), rng.choice(lines))
    return out


@pytest.mark.parametrize("relations,granule", [
    (("bid",), 512), (("person", "auction"), 256),
    (("person", "auction", "bid"), 1024), (("auction", "bid"), 100)])
def test_fragment_lines_equal_reference(epochs, ref_epochs, relations,
                                        granule):
    """The producer's lines, from the port's generator and the
    reference's, byte for byte (persons' vocabulary strings decoded)."""
    got = fragment_lines(epochs, "qb", granule=granule, relations=relations)
    want = ref_ingest.fragment_lines(ref_epochs, "qb", granule=granule,
                                     relations=relations)
    assert got == want


# (query, relations, granule, scramble seed)
INGEST_CASES = {
    "q2-out-of-order": (2, ("bid",), 512, 7),
    "q3-multi-relation": (3, ("person", "auction"), 256, 3),
    "q4-k1": (4, ("auction", "bid"), 256, 5),
}


@pytest.mark.parametrize("case", sorted(INGEST_CASES))
def test_ingest_equals_reference(epochs, case):
    """The port's IngestDriver on scrambled, duplicated lines: the rows of
    the reference's IngestDriver on the same lines and of the port's
    StreamDriver on the epochs, exactly (q4 runs K1's plain path)."""
    q, rels, granule, seed = INGEST_CASES[case]
    lines = scrambled(fragment_lines(epochs, f"q{q}", granule=granule,
                                     relations=rels), seed=seed)
    got = IngestDriver(get_query(q), SECONDS, f"q{q}",
                       device="cpu").run(lines)
    want = ref_ingest.IngestDriver(ref_get_query(q), SECONDS,
                                   f"q{q}").run(lines)
    direct = StreamDriver(get_query(q), SECONDS, device="cpu").run(epochs)
    names = get_query(q).schema.names
    assert [r.tag for r in got] == [r.tag for r in want]
    assert all_rows(got, names) == all_rows(want, names)
    assert all_rows(got, names) == all_rows(direct, names)
    assert any(len(r.columns[names[0]]) for r in got)


def test_ingest_incomplete_stream_raises(epochs):
    lines = fragment_lines(epochs, "qx", granule=512)
    with pytest.raises(ValueError, match="incomplete"):
        IngestDriver(get_query(2), SECONDS, "qx", device="cpu").run(
            lines[:-1])


def test_epoch_assembler_in_order_release(epochs):
    """Fully reversed arrival: epochs release in stream order, each with
    the reference assembler's tables."""
    lines = fragment_lines(epochs, "qa", granule=512)
    asm = EpochAssembler("qa", ("bid",), SECONDS)
    ref = ref_ingest.EpochAssembler("qa", ("bid",), SECONDS)
    released = []
    for line in reversed(lines):
        got, want = asm.feed(line), ref.feed(line)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, g), (_, w) in zip(got, want):
            for k in w["bid"]:
                assert np.array_equal(g["bid"][k], w["bid"][k])
                assert g["bid"][k].dtype == w["bid"][k].dtype
        released.extend(t for t, _ in got)
    assert released == list(range(SECONDS))
    assert asm.done


def test_socket_ingest_end_to_end(epochs, ref_epochs):
    spec = get_query(2)
    lines = scrambled(fragment_lines(epochs, "qs", granule=512), seed=11)
    srv = SocketIngestServer()
    try:
        producer = threading.Thread(
            target=send_fragments, args=(srv.address, lines), daemon=True)
        producer.start()
        results = IngestDriver(spec, SECONDS, "qs", device="cpu").run(
            srv.lines(len(lines), timeout_s=LINES_TIMEOUT_S))
        producer.join(10)
        assert not producer.is_alive()
    finally:
        srv.close()
    direct = RefStreamDriver(ref_get_query(2), SECONDS).run(ref_epochs)
    names = spec.schema.names
    assert all_rows(results, names) == all_rows(direct, names)


def test_file_tail_ingest(tmp_path, epochs, ref_epochs):
    spec = get_query(2)
    lines = scrambled(fragment_lines(epochs, "qf", granule=512), seed=5)
    log = tmp_path / "frags.jsonl"
    log.write_text("")

    def producer():
        with open(log, "a") as f:
            for i, line in enumerate(lines):
                f.write(line + "\n")
                if i % 7 == 0:
                    f.flush()
            f.flush()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    src = FileTailSource(str(log), n_lines=len(lines),
                         timeout_s=LINES_TIMEOUT_S)
    results = IngestDriver(spec, SECONDS, "qf", device="cpu").run(src)
    t.join(10)
    assert not t.is_alive()
    direct = RefStreamDriver(ref_get_query(2), SECONDS).run(ref_epochs)
    names = spec.schema.names
    assert all_rows(results, names) == all_rows(direct, names)


def _same_columns(got: tuple, want: tuple):
    (grel, gcols), (wrel, wcols) = got, want
    assert grel == wrel
    assert list(gcols) == list(wcols)
    for k in wcols:
        assert gcols[k].dtype == wcols[k].dtype, k
        assert gcols[k].tolist() == wcols[k].tolist(), k


@pytest.mark.parametrize("fixture,parse,ref_parse", [
    ("example-kafka-event.json", kafka_event_to_columns,
     ref_ingest.kafka_event_to_columns),
    ("example-kinesis-event-1.json", kinesis_event_to_columns,
     ref_ingest.kinesis_event_to_columns)])
def test_trigger_event_fixtures(fixture, parse, ref_parse):
    """The reference repository's own trigger events parse to the
    reference's (relation, columns), generic schema inference included."""
    with open(os.path.join(GOLDEN, fixture)) as f:
        event = json.load(f)
    _same_columns(parse(event), ref_parse(event))


def test_kinesis_non_json_payload_rejected():
    with open(os.path.join(GOLDEN, "example-kinesis-event.json")) as f:
        event = json.load(f)
    with pytest.raises(json.JSONDecodeError):
        kinesis_event_to_columns(event)


def test_kafka_trigger_nexmark_payload(epochs):
    """A kafka event whose values are reference-format bid rows routes to
    the typed bid parser (the native one), as the reference's."""
    bid = epochs[0]["bid"]
    lines = [json.dumps({
        "auction": int(bid["auction"][i]), "bidder": int(bid["bidder"][i]),
        "price": int(bid["price"][i]),
        "b_date_time": int(bid["b_date_time"][i]),
    }) for i in range(len(bid["auction"]))]
    event = {"records": {"topic-0": [
        {"value": base64.b64encode(ln.encode()).decode()} for ln in lines]}}
    got = kafka_event_to_columns(event)
    _same_columns(got, ref_ingest.kafka_event_to_columns(event))
    assert got[0] == "bid"
    for k, v in got[1].items():
        assert np.array_equal(v, bid[k])


def test_generic_lines_and_inference():
    lines = ['{"a": 1, "b": 2.5, "c": "x", "d": true}',
             '{"a": -3, "b": 4, "c": "y", "d": false}']
    got = parse_generic_lines(lines)
    want = ref_ingest.parse_generic_lines(lines)
    _same_columns(("generic", got), ("generic", want))
    for row in ({"auction": 1, "bidder": 2, "price": 3, "b_date_time": 4},
                {"x": 1}):
        assert infer_relation(row) == ref_ingest.infer_relation(row)


def test_send_fragments_reconnects_midstream(epochs, monkeypatch):
    """A transport fault mid-send reconnects with backoff and resumes from
    a rewound position (at-least-once; the arena drops duplicates)."""
    import socket as socket_mod

    lines = fragment_lines(epochs[:2], "retry-q", granule=256)
    srv = SocketIngestServer()
    real_socket = socket_mod.socket
    state = {"calls": 0}

    # the producer pins SO_SNDBUF before connect, so the fault wraps
    # socket.socket itself; connects are counted per producer socket
    class _FlakySock:
        def __init__(self, *a, **kw):
            self._inner = real_socket(*a, **kw)
            self._sent = 0

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self._inner.close()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def connect(self, address):
            state["calls"] += 1
            return self._inner.connect(address)

        def sendall(self, data):
            self._sent += 1
            if state["calls"] == 1 and self._sent > len(lines) // 2:
                raise ConnectionResetError("injected mid-stream fault")
            self._inner.sendall(data)

    monkeypatch.setattr("socket.socket", _FlakySock)
    try:
        send_fragments(srv.address, lines)
        deadline = time.monotonic() + DEADLINE_S
        got: list = []
        while time.monotonic() < deadline:
            with srv._cv:
                got = list(srv._lines)
            if set(got) >= set(lines):
                break
            time.sleep(0.05)
    finally:
        srv.close()
    assert state["calls"] >= 2
    assert set(got) >= set(lines)
    # the duplicates the rewind resent reassemble to the same epochs
    asm = EpochAssembler("retry-q", ("bid",), 2)
    released = [t for line in got for t, _ in asm.feed(line)]
    assert released == [0, 1]


def test_file_state_write_retries_transient_fault(tmp_path, monkeypatch):
    from flock_tpu_torch.runtime.payload import FragmentId, Payload
    from flock_tpu_torch.runtime.state import FileStateBackend

    backend = FileStateBackend(root=str(tmp_path))
    p = Payload(FragmentId("rq", 0, 1, 0),
                {"bidder": np.array([1, 2], np.int64),
                 "b_date_time": np.array([10, 20], np.int64)})
    real_replace = os.replace
    state = {"fails": 2}

    def flaky_replace(src, dst):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise OSError("injected transient fault")
        return real_replace(src, dst)

    monkeypatch.setattr("os.replace", flaky_replace)
    backend.write(0, p)
    assert state["fails"] == 0
    got = backend.read("rq", 0, 0, 0)
    assert got is not None and got.columns["bidder"].tolist() == [1, 2]
