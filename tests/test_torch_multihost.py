"""The multi-process path on the CPU: two gloo processes × 4 local shards
(one mesh of 8) run q2 and q4 through ``MultiHostExecutor``, and the
two-process CLI command (``nexmark run --multihost``), each process
generating only its own partitions; their rows equal the single-process
8-shard run's (PyTorch port, CPU).

The file runs itself as the worker (``python tests/test_torch_multihost.py
MODE PID PORT OUTDIR QUERY``), so a worker imports nothing of the tests'
JAX configuration; every process and collective has a timeout."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SECONDS, EPS, GENS, LOCAL = 2, 2000, 8, 4
TIMEOUT_S = 120


def _rows(spec, cols) -> list:
    names = spec.schema.names
    return sorted(tuple(map(str, r)) for r in
                  zip(*(np.asarray(cols[n]).tolist() for n in names)))


def _worker(mode: str, pid: int, port: int, outdir: str, qnum: int) -> int:
    import torch

    torch.set_num_threads(1)
    if mode == "cli":
        from flock_tpu_torch.cli import main

        return main(["nexmark", "run", "-q", str(qnum), "-s", str(SECONDS),
                     "-e", str(EPS), "-g", str(GENS), "--show", "1000",
                     "--distributed", "--multihost", "--coordinator",
                     f"127.0.0.1:{port}", "--num-processes", "2",
                     "--process-id", str(pid), "--device", "cpu"])
    import torch.distributed as dist

    from flock_tpu_torch.parallel.mesh import make_multihost_mesh
    from flock_tpu_torch.parallel.multihost import (MultiHostExecutor,
                                                    init_distributed,
                                                    local_partition_ids)
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.executor import materialize_columns
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations

    init_distributed(f"127.0.0.1:{port}", 2, pid, backend="gloo",
                     timeout_s=TIMEOUT_S)
    try:
        mesh = make_multihost_mesh(LOCAL, device="cpu")
        assert mesh.n_shards == 8 and mesh.process_count == 2
        spec = get_query(qnum)
        rels = tuple(r for r in spec.relations if r != "side_input")
        parts = generate_epoch_parts(SECONDS, EPS, GENS)
        mine = set(local_partition_ids(GENS, mesh))
        ex = MultiHostExecutor(spec, mesh=mesh, agg_capacity=4096)
        tables = []
        for shard in ex.local_shards:
            owned = [p for p in range(GENS) if p % mesh.n_shards == shard]
            assert set(owned) <= mine
            tables.append(dict(concat_relations(
                [parts[t][p] for t in range(SECONDS) for p in owned],
                rels)))
        cols = materialize_columns(spec, ex.execute_window(tables))
        local = materialize_columns(spec, ex.execute_window(tables,
                                                            gather=False))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rows_{pid}.json"), "w") as f:
        json.dump({"all": _rows(spec, cols), "local": _rows(spec, local)}, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode: str, outdir, qnum: int) -> list[str]:
    """Both worker processes; their output, each within the timeout."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(pid),
         str(port), str(outdir), str(qnum)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


def _single_process(qnum: int):
    """The single-process 8-shard run over the same data as one window."""
    from flock_tpu_torch.parallel.stream import DistStreamDriver
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import generate_epoch_parts

    spec = get_query(qnum)
    parts = generate_epoch_parts(SECONDS, EPS, GENS)
    (res,) = DistStreamDriver(spec, 1, 8, device="cpu").run(
        [[p for epoch in parts for p in epoch]])
    return spec, res.columns


@pytest.mark.parametrize("qnum", [2, 4])
def test_two_process_multihost_matches_single_process(tmp_path, qnum):
    _launch("exec", tmp_path, qnum)
    got = []
    for pid in (0, 1):
        rec = json.load(open(tmp_path / f"rows_{pid}.json"))
        got.append({k: [tuple(r) for r in v] for k, v in rec.items()})
    spec, cols = _single_process(qnum)
    want = _rows(spec, cols)
    assert want
    # with gather, both processes return every shard's rows
    assert got[0]["all"] == got[1]["all"] == want
    # without, each its own shards' rows: together, all of them
    assert sorted(got[0]["local"] + got[1]["local"]) == want


def test_two_process_multihost_cli(tmp_path):
    """``nexmark run -q 4 --distributed --multihost`` in two processes:
    process 0 prints the global window, the single-process rows."""
    from flock_tpu_torch.cli import _print_window

    outs = _launch("cli", tmp_path, 4)
    spec, cols = _single_process(4)
    n = len(cols["category"])
    assert f"q4 multihost: 2 process(es) × 8 shards, {n} output rows" \
        in outs[0]
    assert "multihost:" not in outs[1]
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _print_window(("multihost", 0, SECONDS), cols, spec.schema, 1000)
    assert buf.getvalue() in outs[0]


if __name__ == "__main__":
    mode, pid, port, outdir, qnum = sys.argv[1:6]
    sys.exit(_worker(mode, int(pid), int(port), outdir, int(qnum)))
