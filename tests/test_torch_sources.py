"""The port's source layer against flock_tpu's: the scalar generator (column
for column against the reference's and the port's native generator),
``dump_events_json``'s files byte for byte, ``JsonFileSource`` against the
native epochs, the native JSONL parser against the Python parser, the
stream interfaces and the test utilities (tests/test_sources.py and
tests/test_generator.py:27-37, on the port) (PyTorch port, CPU)."""

import json

import numpy as np
import pytest

from flock_tpu.datagen import sources as ref_sources
from flock_tpu.datagen.nexmark import NexmarkConfig as RefNexmarkConfig
from flock_tpu.datagen.nexmark import ScalarGenerator as RefScalarGenerator
from flock_tpu.utils import testing as ref_testing
from flock_tpu_torch.datagen.native_gen import nexmark_generate_partition
from flock_tpu_torch.datagen.nexmark import NexmarkConfig, ScalarGenerator
from flock_tpu_torch.datagen.sources import (
    JsonFileSource,
    NexmarkSource,
    YsbSource,
    dump_events_json,
    parse_auction_lines,
    parse_bid_lines,
    parse_person_lines,
)
from flock_tpu_torch.native import jsonl_parse_int_columns
from flock_tpu_torch.runtime.stream import generate_epochs
from flock_tpu_torch.utils.testing import (assert_columns_equal,
                                           pretty_format, sorted_rows)

COLS = [
    "p_id", "p_name_code", "p_city_code", "p_state_code", "p_date_time",
    "a_id", "a_initial_bid", "a_reserve", "a_date_time", "a_expires",
    "a_seller", "a_category",
    "b_auction", "b_bidder", "b_price", "b_date_time",
]


@pytest.mark.parametrize("partition", [0, 1])
def test_scalar_generator_equals_reference_and_native(partition):
    """2 generators × 2 partitions (tests/test_generator.py:27-37): the
    port's ScalarGenerator equals the reference's and the port's native
    generator, column for column and dtype for dtype."""
    cfg = NexmarkConfig(events_per_second=2000, num_event_generators=2)
    ref_cfg = RefNexmarkConfig(events_per_second=2000, num_event_generators=2)
    py = ScalarGenerator(cfg, seconds=2).generate_partition(partition)
    ref = RefScalarGenerator(ref_cfg, seconds=2).generate_partition(partition)
    nat = nexmark_generate_partition(cfg, 2, partition)
    assert len(py) == len(ref) == len(nat)
    for a, b, c in zip(py, ref, nat):
        assert a.epoch == b.epoch == c.epoch
        for f in COLS:
            x, y, z = getattr(a, f), getattr(b, f), getattr(c, f)
            assert x.dtype == y.dtype == z.dtype, f
            assert np.array_equal(x, y) and np.array_equal(x, z), f


def test_materialized_strings_equal_reference():
    cfg = NexmarkConfig(events_per_second=500)
    ref_cfg = RefNexmarkConfig(events_per_second=500)
    gen = ScalarGenerator(cfg, 1, materialize_strings=True)
    ref = RefScalarGenerator(ref_cfg, 1, materialize_strings=True)
    for e in range(0, 500, 7):
        assert gen.generate_event(e, 0) == ref.generate_event(e, 0)
    (a,), (b,) = gen.generate_partition(0), ref.generate_partition(0)
    assert a.strings == b.strings and set(a.strings) == {
        "p_name", "p_email_address", "p_credit_card", "p_city", "p_state",
        "a_item_name", "a_description"}


@pytest.mark.parametrize("partition,generators", [(0, 1), (1, 2)])
def test_dump_events_json_equals_reference(tmp_path, partition, generators):
    got = dump_events_json(str(tmp_path / "port"), 1, 1000, partition,
                           generators)
    want = ref_sources.dump_events_json(str(tmp_path / "ref"), 1, 1000,
                                        partition, generators)
    assert list(got) == list(want) == ["person", "auction", "bid"]
    for rel in got:
        with open(got[rel], "rb") as g, open(want[rel], "rb") as w:
            data = g.read()
            assert data == w.read(), rel
        assert data, rel


def test_json_roundtrip_matches_native(tmp_path):
    """Scalar generator (full strings) → reference-format JSONL → parsed
    back: the native generator's columns (tests/test_sources.py)."""
    paths = dump_events_json(str(tmp_path / "ev"), seconds=1,
                             events_per_second=1000)
    native = generate_epochs(1, 1000)[0]
    names = {"bid": ["auction", "bidder", "price", "b_date_time"],
             "person": ["p_id", "name", "city", "state", "p_date_time"],
             "auction": ["a_id", "initial_bid", "reserve", "a_date_time",
                         "expires", "seller", "category"]}
    for rel, cols in names.items():
        got = JsonFileSource(paths[rel], rel).load()
        want = ref_sources.JsonFileSource(paths[rel], rel).load()
        assert_columns_equal(got, native[rel], cols)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (rel, k)


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    d = tmp_path_factory.mktemp("jsonl")
    paths = dump_events_json(str(d / "ev"), seconds=1,
                             events_per_second=2000)
    out = {}
    for rel, p in paths.items():
        with open(p) as f:
            out[rel] = f.read().splitlines()
    return out


@pytest.mark.parametrize("rel,parse,ref_parse", [
    ("bid", parse_bid_lines, ref_sources.parse_bid_lines),
    ("auction", parse_auction_lines, ref_sources.parse_auction_lines),
    ("person", parse_person_lines, ref_sources.parse_person_lines)])
def test_parsers_equal_reference(dumped, rel, parse, ref_parse):
    """Each relation's parser, on the lines and on their bytes, equals the
    reference's (bid and auction take the native parser)."""
    lines = dumped[rel]
    for arg in ((lines, "\n".join(lines).encode()) if rel != "person"
                else (lines,)):
        got, want = parse(arg), ref_parse(arg)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def _python_ints(lines, keys):
    rows = [json.loads(ln) for ln in lines if ln.strip()]
    return {k: np.array([r[k] for r in rows], np.int64) for k in keys}


def test_native_jsonl_parser_equals_python(dumped):
    """Conforming rows (every requested key an integer; strings, floats,
    booleans and nulls elsewhere skipped): the Python parser's columns."""
    for rel, keys in (("bid", ["auction", "bidder", "price",
                               "b_date_time"]),
                      ("auction", ["a_id", "seller", "expires",
                                   "category"]),
                      ("person", ["p_id", "p_date_time"])):
        lines = dumped[rel]
        got = jsonl_parse_int_columns("\n".join(lines).encode(), keys,
                                      len(lines))
        want = _python_ints(lines, keys)
        for k in keys:
            assert np.array_equal(got[k], want[k]), (rel, k)
    lines = ['{"a": -5, "s": "x\\"y}", "f": 1.5e3, "t": true, "n": null}',
             "", '  {"f": -0.25, "a": 9223372036854775807}  ']
    got = jsonl_parse_int_columns("\n".join(lines).encode(), ["a"], 3)
    assert got["a"].tolist() == [-5, 2**63 - 1]


@pytest.mark.parametrize("line", [
    '{"a": 1.5}', '{"a": "1"}', '{"b": 1}', '{"a": [1]}', '{"a": {"x": 1}}',
    '[1, 2]', '{"a": 99999999999999999999}', '{"a": true}', '{"a": 1, "c":'
    ' [2]}'])
def test_native_jsonl_parser_refuses_other_rows(line):
    """A row that is not a flat object with an integer for every requested
    key returns None (the caller takes the Python parser)."""
    data = ('{"a": 1}\n' + line).encode()
    assert jsonl_parse_int_columns(data, ["a"], 2) is None
    assert ref_sources._parse_int_lines_native(
        ['{"a": 1}', line], (("a", np.int64),)) is None


def test_source_interfaces():
    eps = NexmarkSource(seconds=1, events_per_second=500).epochs()
    ref = ref_sources.NexmarkSource(seconds=1, events_per_second=500).epochs()
    assert len(eps) == 1 and len(eps[0]["bid"]["auction"]) == 460
    for rel in ref[0]:
        for k in ref[0][rel]:
            assert np.array_equal(eps[0][rel][k], ref[0][rel][k])
    ysb = YsbSource(seconds=2, events_per_second=500).epochs()
    ref = ref_sources.YsbSource(seconds=2, events_per_second=500).epochs()
    assert len(ysb) == len(ref) == 2
    for e, r in zip(ysb, ref):
        for k in r["ad_event"]:
            assert np.array_equal(e["ad_event"][k], r["ad_event"][k])


@pytest.mark.parametrize("n,limit", [(0, 20), (2, 20), (25, 20), (5, 3)])
def test_pretty_format_equals_reference(n, limit):
    rng = np.random.default_rng(n)
    cols = {"a": rng.integers(-999, 99_999, n),
            "bb": rng.random(n), "c": np.array(["x" * (i % 4)
                                                for i in range(n)])}
    names = ["a", "bb", "c"]
    got = pretty_format(cols, names, limit)
    assert got == ref_testing.pretty_format(cols, names, limit)
    assert got.count("\n") == 3 + min(n, limit) + (n > limit)


def test_sorted_rows_and_assert_columns_equal():
    a = {"x": np.array([3, 1, 2]), "y": np.array([30, 10, 20])}
    b = {"x": np.array([1, 2, 3]), "y": np.array([10, 20, 30])}
    assert sorted_rows(a, ["x", "y"]) == ref_testing.sorted_rows(a, ["x", "y"])
    assert_columns_equal(a, b, ["x", "y"])
    with pytest.raises(AssertionError, match="row mismatch: 3 vs 2"):
        assert_columns_equal(a, {k: v[:2] for k, v in b.items()}, ["x", "y"])
