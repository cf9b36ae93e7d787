"""Data sinks — a copy of ``DataSink``, ``BlackholeSink``, ``MemorySink``,
``FileSink`` and ``make_sink`` from ``flock_tpu/runtime/sink.py`` (the
DataSink analogue, flock/src/datasink/mod.rs).  ``FileSink``'s default
directory is ``<tempdir>/flock_tpu_torch_out``.

Reference sinks: Blackhole (default benchmark sink), S3, SQS, EFS, DynamoDB
(stub), with read-back so the client can verify results.  Here: Blackhole,
Memory (read-back for tests/benchmarks), File (CSV/JSONL — q10's partitioned
filesystem sink), all behind one interface.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

from flock_tpu_torch.batch import Schema


class DataSink:
    def write(self, tag, columns: dict[str, np.ndarray], schema: Schema) -> None:
        raise NotImplementedError

    def read(self):
        """Read-back for verification (datasink/mod.rs:158-171)."""
        return []


@dataclass
class BlackholeSink(DataSink):
    rows_seen: int = 0

    def write(self, tag, columns, schema):
        if columns:
            self.rows_seen += len(next(iter(columns.values())))


@dataclass
class MemorySink(DataSink):
    results: list = field(default_factory=list)

    def write(self, tag, columns, schema):
        self.results.append((tag, schema.decode(columns)))

    def read(self):
        return self.results


@dataclass
class FileSink(DataSink):
    """JSONL/CSV sink partitioned by window tag (q10's fs sink analogue:
    one file per window, reference q10.sql 'partitioned file system')."""

    directory: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "flock_tpu_torch_out"))
    fmt: str = "jsonl"  # or "csv"
    paths: list = field(default_factory=list)

    def write(self, tag, columns, schema):
        os.makedirs(self.directory, exist_ok=True)
        name = "-".join(str(t) for t in (tag if isinstance(tag, tuple) else (tag,)))
        path = os.path.join(self.directory, f"{name}.{self.fmt}")
        decoded = schema.decode(columns)
        n = len(next(iter(decoded.values()))) if decoded else 0
        with open(path, "w") as f:
            if self.fmt == "csv":
                f.write(",".join(schema.names) + "\n")
                for i in range(n):
                    f.write(",".join(str(decoded[k][i]) for k in schema.names) + "\n")
            else:
                for i in range(n):
                    f.write(json.dumps(
                        {k: _py(decoded[k][i]) for k in schema.names}) + "\n")
        self.paths.append(path)

    def read(self):
        return list(self.paths)


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def make_sink(kind: str, **kw) -> DataSink:
    return {"blackhole": BlackholeSink, "memory": MemorySink,
            "file": FileSink}[kind](**kw)
