"""Stage-DAG planner: chops a plan at exchange boundaries — a copy of
``flock_tpu/planner.py`` over the port's plan nodes (plain Python).

Reference counterpart: ``DistributedPlanner::plan_query_stages`` +
``build_query_dag_from_serde_json`` (flock/src/distributed_plan/
{planner.rs:26-59, stage.rs:265-367}), which splits DataFusion plans at
final hash-aggregates and joins, and deploys one Lambda (group) per stage.

Here stages are *phases of one SPMD program* — the boundary between two
stages lowers to a collective (all_to_all for aggregate shuffles, all_gather
for broadcast joins) instead of a payload hop, see parallel/executor.py.  The
DAG itself is kept for introspection, EXPLAIN output, and planner parity
tests (the reference asserts q1⇒1, q2⇒1, q3⇒2, q4⇒4 stages, YSB⇒3 —
planner.rs:93,125,172,256,343; this planner reproduces those counts).

Boundary rules (mirroring stage.rs):
* ``Aggregate`` — partial agg closes the current stage; the final agg opens a
  new one behind a hash exchange (DataFusion's Partial/Final split);
* ``Join`` — both children close into one fan-in stage; the join itself opens
  a new stage behind a broadcast exchange (stage.rs: "both children become
  one fan-in stage").
"""

from __future__ import annotations

from dataclasses import dataclass, field

from flock_tpu_torch.plan import (
    Aggregate,
    Compact,
    Filter,
    Join,
    Node,
    Project,
    Rank,
    Scan,
    Sort,
)


@dataclass
class Stage:
    id: int
    ops: list[str] = field(default_factory=list)


@dataclass
class QueryDag:
    stages: list[Stage] = field(default_factory=list)
    # (src_stage, dst_stage, exchange kind: "hash(...)" | "broadcast" | "shuffle(...)")
    edges: list[tuple[int, int, str]] = field(default_factory=list)

    def new_stage(self) -> Stage:
        s = Stage(id=len(self.stages))
        self.stages.append(s)
        return s

    def explain(self) -> str:
        lines = []
        for s in self.stages:
            lines.append(f"Stage {s.id}:")
            for op in s.ops:
                lines.append(f"  {op}")
            for src, dst, kind in self.edges:
                if src == s.id:
                    lines.append(f"  → stage {dst} via {kind}")
        return "\n".join(lines)


def _describe(node: Node) -> str:
    if isinstance(node, Scan):
        return f"Scan({node.relation})"
    if isinstance(node, Filter):
        return f"Filter[{node.label or 'pred'}]"
    if isinstance(node, Project):
        return f"Project[{', '.join(n for n, _ in node.exprs)}]"
    if isinstance(node, Rank):
        return f"Rank[{node.rank_name} over {node.group_key}]"
    if isinstance(node, Sort):
        return f"Sort{node.keys}"
    if isinstance(node, Compact):
        return f"Compact[{node.out_capacity}]"
    return type(node).__name__


def plan_query_stages(root: Node) -> QueryDag:
    dag = QueryDag()

    def build(node: Node) -> Stage:
        """Returns the currently-open stage producing this node's output."""
        if isinstance(node, Scan):
            s = dag.new_stage()
            s.ops.append(_describe(node))
            return s
        if isinstance(node, (Filter, Project, Rank, Sort, Compact)):
            s = build(node.child)
            s.ops.append(_describe(node))
            return s
        if isinstance(node, Aggregate):
            s = build(node.child)
            keys = ",".join(node.group_keys)
            s.ops.append(f"Aggregate[partial by ({keys})]")
            nxt = dag.new_stage()
            nxt.ops.append(f"Aggregate[final by ({keys})]")
            dag.edges.append((s.id, nxt.id, f"hash({keys})"))
            return nxt
        if isinstance(node, Join):
            b = build(node.build)
            p = build(node.probe)
            if b.id != p.id:
                # fan-in: merge both children into one producing stage
                b.ops.extend(p.ops)
                dag.stages.remove(p)
                for i, (src, dst, k) in enumerate(dag.edges):
                    dag.edges[i] = (b.id if src == p.id else src,
                                    b.id if dst == p.id else dst, k)
            nxt = dag.new_stage()
            nxt.ops.append(
                f"LookupJoin[{node.build_key}={node.probe_key}]"
                + (" + post-filter" if node.post_filter else ""))
            dag.edges.append((b.id, nxt.id, "broadcast(build)"))
            return nxt
        raise TypeError(type(node))

    build(root)
    # re-number sequentially (merges may have left gaps)
    remap = {s.id: i for i, s in enumerate(dag.stages)}
    for s in dag.stages:
        s.id = remap.get(s.id, s.id)
    dag.edges = [(remap.get(a, a), remap.get(b, b), k) for a, b, k in dag.edges]
    return dag
