"""The stage-DAG planner on the port's plans: the reference's stage counts
(planner.rs:93,125,172,256,343), the fan-in stage, ``explain``, the golden
DAG files of every query, and the same text as flock_tpu's planner for
every query and SQL text (PyTorch port, CPU)."""

import os

import pytest

from flock_tpu.planner import plan_query_stages as ref_plan_query_stages
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.sql.catalog import nexmark_catalog as ref_catalog
from flock_tpu.sql.lower import sql_to_spec as ref_sql_to_spec
from flock_tpu_torch.planner import plan_query_stages
from flock_tpu_torch.queries.nexmark import QUERIES, get_query
from flock_tpu_torch.queries.ysb import ysb_query
from flock_tpu_torch.sql.catalog import nexmark_catalog
from flock_tpu_torch.sql.lower import sql_to_spec
from test_sql import NEXMARK_SQL

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_dags")


@pytest.mark.parametrize("qnum,expected", [(1, 1), (2, 1), (3, 2), (4, 4)])
def test_nexmark_stage_counts(qnum, expected):
    dag = plan_query_stages(get_query(qnum).plan)
    assert len(dag.stages) == expected, dag.explain()


def test_ysb_stage_count():
    assert len(plan_query_stages(ysb_query().plan).stages) == 3


def test_q3_fan_in_stage():
    # stage 0 holds both filtered scans (stage.rs fan-in), stage 1 the join
    dag = plan_query_stages(get_query(3).plan)
    ops0 = " ".join(dag.stages[0].ops)
    assert "Scan(person)" in ops0 and "Scan(auction)" in ops0
    assert any("LookupJoin" in op for op in dag.stages[1].ops)


def test_explain_renders():
    text = plan_query_stages(get_query(4).plan).explain()
    assert "Stage 0" in text and "hash(" in text and "broadcast" in text


@pytest.mark.parametrize("name", [f"q{n}" for n in sorted(QUERIES)] + ["ysb"])
def test_golden_dag_files(name):
    spec = ysb_query() if name == "ysb" else get_query(int(name[1:]))
    want = open(os.path.join(GOLDEN, f"{name}.dag")).read()
    assert plan_query_stages(spec.plan).explain() + "\n" == want


@pytest.mark.parametrize("qnum", sorted(NEXMARK_SQL))
def test_explain_equals_reference(qnum):
    """The hand plan's and the SQL text's DAGs read as the reference's."""
    assert plan_query_stages(get_query(qnum).plan).explain() \
        == ref_plan_query_stages(ref_get_query(qnum).plan).explain()
    sql = NEXMARK_SQL[qnum]
    assert plan_query_stages(sql_to_spec(sql, nexmark_catalog()).plan) \
        .explain() == ref_plan_query_stages(
            ref_sql_to_spec(sql, ref_catalog()).plan).explain()
