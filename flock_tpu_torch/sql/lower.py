"""SQL AST → plan IR lowering (the DataFusion planner analogue) — a port of
``flock_tpu/sql/lower.py`` (``LoweredRel``, ``_cols_in``, ``_conjuncts``,
``_compile_expr``, ``_mul``, ``_expr_name``, ``Lowerer``, ``sql_to_spec``)
from ``jnp`` expressions to torch, onto the port's plan IR.

Where the port differs:

* comparisons are emitted as ``plan.Conj`` where they can be: a comparison
  ``< <= > >= = !=`` between two columns, a ``BETWEEN`` whose three
  operands are columns, an AND of such parts (the terms merged), and the
  secondary ON equalities (q9's ``price = final``).  Kernel K1 reads only
  ``Conj`` terms, and a ``Conj`` survives the renaming Project a join adds
  (the build-key alias), so SQL q4 and q9 keep the fused pass.  Everything
  else stays a callable: string literals resolved through dictionaries,
  ``%``, arithmetic, OR, literals;
* the reference's planner statistics (``probe_s_loc``, ``build_s_loc``,
  ``take_limbs``, ``Aggregate.s_loc``: TPU locality and limb hints) are
  left out; ``unique_build`` stays.

Reference counterpart: Flock plans SQL with DataFusion and chops the physical
plan (flock/src/query.rs:171-186, runtime/plan.rs:118-125).  The lowering
makes these decisions:

* join sides: the side whose join column is a *unique key* (catalog metadata,
  a GROUP BY output, or a one-row aggregate) becomes the lookup-join build
  side; remaining ON equalities become post-filters (q9's price = final);
* predicate pushdown: WHERE conjuncts referencing one side's columns filter
  below the join (q3's category/state filters);
* functional-dependency rewrite: GROUP BY (k, dep…) lowers to the dense
  single-key aggregation on k with dependent columns carried by max() when
  the catalog proves k → dep (q8's p_id→name); a dependent key that a join
  carried (q4's category) keeps the honest two-key form;
* exact-money bookkeeping: float literals and AVG lower to f32 on device plus
  hidden integer basis columns; the sink recomputes exact f64
  (Schema.f64_recompute).

String literals compare against dictionary codes resolved from the catalog.
Top-level ORDER BY is parsed but dropped (results are sets; the reference's
own tests compare sorted, test_util.rs:61-84).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from flock_tpu_torch.batch import Schema
from flock_tpu_torch.plan import (Aggregate, Conj, Filter, Join, Node,
                                  Project, Rank, Scan)
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.sql import parser as P
from flock_tpu_torch.sql.catalog import Catalog


@dataclass
class LoweredRel:
    plan: Node
    columns: list[str]
    unique_keys: set[str] = field(default_factory=set)
    # STRUCTURALLY-guaranteed unique keys (catalog hard_unique facts and
    # aggregate-output group keys): joins built on these declare
    # unique_build, skipping the duplicate fan-out expansion buffer;
    # soft unique_keys only nominate the build side
    hard_unique_keys: set[str] = field(default_factory=set)
    single_row: bool = False
    functional_deps: dict[str, set[str]] = field(default_factory=dict)
    dictionaries: dict[str, list] = field(default_factory=dict)
    timestamp_cols: set[str] = field(default_factory=set)
    f64: dict[str, tuple] = field(default_factory=dict)
    base_relations: set[str] = field(default_factory=set)
    # columns that arrived as TAKEN build columns of a join (plus the build
    # key alias): functional dependencies through these hold only while the
    # build keys are actually unique, so GROUP BY keeps the honest multi-key
    # form and lets the engine's runtime duplicate detection govern
    join_carried: set[str] = field(default_factory=set)


def _cols_in(e) -> set[str]:
    if isinstance(e, P.Col):
        return {e.name}
    if isinstance(e, P.BinOp):
        return _cols_in(e.left) | _cols_in(e.right)
    if isinstance(e, P.Between):
        return _cols_in(e.expr) | _cols_in(e.low) | _cols_in(e.high)
    if isinstance(e, P.Agg):
        return _cols_in(e.arg) if e.arg is not None else set()
    if isinstance(e, P.WindowFn):
        return set(e.partition_by) | {c for c, _ in e.order_by}
    return set()


def _conjuncts(e) -> list:
    if isinstance(e, P.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _compile_expr(e, dictionaries: dict):
    """AST scalar expr → a ``Conj`` where it is a comparison of columns
    (see the module docstring), else a device callable over the column
    dict."""
    if isinstance(e, P.Col):
        return lambda c, n=e.name: c[n]
    if isinstance(e, P.Lit):
        v = e.value
        if isinstance(v, float):
            # a 0-d CPU tensor: a scalar to any device's elementwise op
            f32 = torch.tensor(v, dtype=torch.float32)
            return lambda c: f32
        return lambda c: v
    if isinstance(e, P.Between):
        if all(isinstance(x, P.Col) for x in (e.expr, e.low, e.high)):
            return Conj(((e.expr.name, ">=", e.low.name),
                         (e.expr.name, "<=", e.high.name)))
        x = _compile_expr(e.expr, dictionaries)
        lo = _compile_expr(e.low, dictionaries)
        hi = _compile_expr(e.high, dictionaries)
        return lambda c: (x(c) >= lo(c)) & (x(c) <= hi(c))
    if isinstance(e, P.BinOp):
        # string literal comparisons resolve through the column's dictionary
        if e.op in ("=", "!=") and isinstance(e.right, P.Lit) \
                and isinstance(e.right.value, str) and isinstance(e.left, P.Col):
            vocab = dictionaries.get(e.left.name)
            if vocab is None:
                raise ValueError(f"no dictionary for column {e.left.name}")
            code = vocab.index(e.right.value)
            name = e.left.name
            if e.op == "=":
                return lambda c: c[name] == code
            return lambda c: c[name] != code
        if e.op in ("<", "<=", ">", ">=", "=", "!=") \
                and isinstance(e.left, P.Col) and isinstance(e.right, P.Col):
            op = "==" if e.op == "=" else e.op
            return Conj(((e.left.name, op, e.right.name),))
        l = _compile_expr(e.left, dictionaries)
        r = _compile_expr(e.right, dictionaries)
        if e.op == "and" and isinstance(l, Conj) and isinstance(r, Conj):
            return Conj(l.terms + r.terms)
        ops = {
            "+": lambda a, b: a + b, "-": lambda a, b: a - b,
            "*": _mul, "/": lambda a, b: a / b,
            "%": lambda a, b: a % b,
            "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "and": lambda a, b: a & b, "or": lambda a, b: a | b,
        }
        op = ops[e.op]
        return lambda c: op(l(c), r(c))
    raise TypeError(f"cannot compile {e}")


def _mul(a, b):
    # float literal * int column → f32 math on device
    if getattr(a, "dtype", None) == torch.float32 or \
            getattr(b, "dtype", None) == torch.float32:
        return torch.as_tensor(a, dtype=torch.float32) \
            * torch.as_tensor(b, dtype=torch.float32)
    return a * b


def _expr_name(e) -> str | None:
    if isinstance(e, P.Col):
        return e.name
    if isinstance(e, P.Agg):
        inner = _expr_name(e.arg) if e.arg is not None else "*"
        return f"{e.fn}_{inner}" if inner != "*" else e.fn
    return None


class Lowerer:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._anon = 0

    # -- FROM ----------------------------------------------------------------

    def lower_tableref(self, tr: P.TableRef) -> LoweredRel:
        if tr.subquery is not None:
            return self.lower_select(tr.subquery)
        t = self.catalog.tables[tr.name]
        return LoweredRel(
            plan=Scan(t.name),
            columns=list(t.columns),
            unique_keys={t.unique_key} if t.unique_key else set(),
            hard_unique_keys={t.unique_key}
            if t.unique_key and t.hard_unique else set(),
            functional_deps={k: set(v) for k, v in t.functional_deps.items()},
            dictionaries=dict(t.dictionaries),
            timestamp_cols=set(t.timestamp_cols),
            base_relations={t.name},
        )

    # -- SELECT --------------------------------------------------------------

    def lower_select(self, sel: P.Select) -> LoweredRel:
        where = _conjuncts(sel.where) if sel.where is not None else []

        if isinstance(sel.from_, P.JoinClause):
            rel, where = self._lower_join(sel.from_, where, sel)
        else:
            rel = self.lower_tableref(sel.from_)

        # residual WHERE
        for term in where:
            pred = _compile_expr(term, rel.dictionaries)
            rel = self._filtered(rel, pred, term)

        if sel.group_by:
            rel = self._lower_groupby(sel, rel)
        else:
            rel = self._lower_projection(sel, rel)
        return rel

    def _filtered(self, rel: LoweredRel, pred, term) -> LoweredRel:
        out = LoweredRel(**{**rel.__dict__})
        out.plan = Filter(rel.plan, pred, label=str(term)[:60])
        return out

    # -- JOIN ----------------------------------------------------------------

    def _lower_join(self, jc: P.JoinClause, where: list, sel: P.Select):
        left = self.lower_tableref(jc.left)
        right = self.lower_tableref(jc.right)

        # predicate pushdown below the join
        residual = []
        for term in where:
            cols = _cols_in(term)
            if cols <= set(left.columns):
                left = self._filtered(left, _compile_expr(term, left.dictionaries), term)
            elif cols <= set(right.columns):
                right = self._filtered(right, _compile_expr(term, right.dictionaries), term)
            else:
                residual.append(term)

        # orient ON pairs as (left_col, right_col)
        pairs = []
        for a, b in jc.on:
            if a in left.columns and b in right.columns:
                pairs.append((a, b))
            elif b in left.columns and a in right.columns:
                pairs.append((b, a))
            else:
                raise ValueError(f"cannot resolve join condition {a}={b}")

        # build side = unique-key (or single-row) side on the first equality
        lk, rk = pairs[0]
        left_unique = lk in left.unique_keys or left.single_row
        right_unique = rk in right.unique_keys or right.single_row
        if right_unique and not left_unique:
            build, probe, bk, pk = right, left, rk, lk
        elif left_unique:
            build, probe, bk, pk = left, right, lk, rk
        else:
            raise ValueError(
                f"no unique-key side for join on {lk}={rk}; "
                f"N:M joins are not supported")

        # columns needed from the build side downstream
        needed = set()
        for e, _ in sel.items:
            needed |= _cols_in(e)
        if sel.star:
            needed |= set(probe.columns) | set(build.columns)
        for term in residual:
            needed |= _cols_in(term)
        needed |= set(sel.group_by)
        extra_eq = pairs[1:]
        for a, b in extra_eq:
            needed |= {a, b}
        take = tuple((c, c) for c in build.columns
                     if c in needed and c != bk and c not in probe.columns)

        plan = Join(build=build.plan, probe=probe.plan,
                    build_key=bk, probe_key=pk, take=take,
                    unique_build=bk in build.hard_unique_keys
                    or build.single_row)
        # materialize the build key under its own name as a zero-cost alias of
        # the probe key (they are equal on surviving rows), so downstream SQL
        # can reference either (q4 groups by a_id; the joined rows carry it as
        # "auction")
        cols = list(probe.columns) + [d for _, d in take]
        exprs = tuple((c, c) for c in cols)
        if bk not in cols:
            exprs += ((bk, pk),)
            cols.append(bk)
        plan = Project(plan, exprs)

        rel = LoweredRel(
            plan=plan,
            columns=cols,
            unique_keys=set(probe.unique_keys),
            dictionaries={**build.dictionaries, **probe.dictionaries},
            timestamp_cols=build.timestamp_cols | probe.timestamp_cols,
            f64={**build.f64, **probe.f64},
            base_relations=build.base_relations | probe.base_relations,
        )
        # key transfer: the probe's join-key column (and its alias) now
        # determines everything the build key determined (q4: "auction" →
        # category after the join)
        det = (build.functional_deps.get(bk, set())
               | {d for _, d in take} | {pk, bk})
        rel.join_carried = {d for _, d in take} | {bk}
        rel.functional_deps = dict(probe.functional_deps)
        for key_col in (pk, bk):
            rel.functional_deps[key_col] = (
                set(rel.functional_deps.get(key_col, set())) | det)

        # secondary ON equalities → post-join filters (q9 price = final)
        for a, b in extra_eq:
            rel = self._filtered(rel, Conj(((a, "==", b),)), f"{a}={b}")
        return rel, residual

    # -- GROUP BY ------------------------------------------------------------

    def _lower_groupby(self, sel: P.Select, rel: LoweredRel) -> LoweredRel:
        keys = list(sel.group_by)
        # functional-dependency rewrite → dense single-key aggregation
        carried: list[str] = []
        if len(keys) > 1:
            for k in keys:
                det = rel.functional_deps.get(k, set())
                others = [o for o in keys if o != k]
                if all(o in det for o in others):
                    if all(o in rel.join_carried for o in others):
                        # dependent keys are taken build columns of a join
                        # (q4's category): keep the honest multi-key form,
                        # primary key first — the fused lowering runs the
                        # dense single-key path while build keys are unique
                        # and escapes to the duplicate-faithful multi-key
                        # aggregation otherwise (plan.FusedJoinAggregate)
                        keys = [k] + others
                    else:
                        carried = others
                        keys = [k]
                    break

        aggs = []
        projections = []   # (out_name, source) applied after the aggregate
        f64 = dict(rel.f64)
        for e, alias in sel.items:
            if isinstance(e, P.Col):
                name = alias or e.name
                if e.name in keys:
                    projections.append((name, e.name))
                elif e.name in carried:
                    aggs.append((e.name, "max", e.name))
                    projections.append((name, e.name))
                else:
                    raise ValueError(
                        f"{e.name} is neither grouped nor aggregated")
            elif isinstance(e, P.Agg):
                name = alias or _expr_name(e)
                argc = e.arg.name if isinstance(e.arg, P.Col) else None
                if e.fn == "count":
                    aggs.append((None, "count", name))
                    projections.append((name, name))
                elif e.fn in ("min", "max", "sum"):
                    aggs.append((argc, e.fn, name))
                    projections.append((name, name))
                elif e.fn == "avg":
                    s, c = f"__sum_{name}", f"__cnt_{name}"
                    aggs.append((argc, "sum", s))
                    aggs.append((None, "count", c))
                    projections.append(
                        (name, lambda cols, s=s, c=c:
                         cols[s].to(torch.float32)
                         / cols[c].clamp_min(1).to(torch.float32)))
                    projections.append((s, s))
                    projections.append((c, c))
                    f64[name] = ("div", s, c)
                else:
                    raise ValueError(e.fn)
            else:
                raise ValueError(f"unsupported select item {e}")
        agg_node = Aggregate(rel.plan, group_keys=tuple(keys),
                             aggs=tuple(aggs))
        proj = Project(agg_node, tuple(
            (n, src) for n, src in projections))

        # Min/Max over a timestamp column stays a timestamp (q11's
        # start_time/end_time): sinks must restore the absolute epoch base
        ts_out = {out for in_c, fn, out in aggs
                  if fn in ("min", "max") and in_c in rel.timestamp_cols}

        unique_out = {n for n, src in projections
                      if isinstance(src, str) and src in keys}
        return LoweredRel(
            plan=proj,
            columns=[n for n, _ in projections],
            unique_keys=unique_out if len(keys) == 1 else set(),
            hard_unique_keys=unique_out if len(keys) == 1 else set(),
            single_row=not keys,
            dictionaries={k: v for k, v in rel.dictionaries.items()},
            timestamp_cols=set(rel.timestamp_cols) | ts_out,
            f64=f64,
            base_relations=rel.base_relations,
        )

    # -- projection (no GROUP BY) --------------------------------------------

    def _lower_projection(self, sel: P.Select, rel: LoweredRel) -> LoweredRel:
        # window functions first
        plan = rel.plan
        rank_aliases = {}
        for e, alias in sel.items:
            if isinstance(e, P.WindowFn):
                name = alias or "row_number"
                (order_col, desc) = e.order_by[0]
                tb = e.order_by[1][0] if len(e.order_by) > 1 else None
                plan = Rank(plan, group_key=e.partition_by[0],
                            order_col=order_col, descending=desc,
                            rank_name=name, tiebreak=tb)
                rank_aliases[id(e)] = name

        if sel.star and all(isinstance(e, P.WindowFn) or
                            isinstance(e, P.Col) for e, _ in sel.items):
            cols = list(rel.columns) + [
                rank_aliases[id(e)] for e, _ in sel.items
                if isinstance(e, P.WindowFn)]
            exprs = tuple((c, c) for c in cols)
            out = LoweredRel(**{**rel.__dict__})
            out.plan = Project(plan, exprs)
            out.columns = cols
            return out

        exprs = []
        names = []
        f64 = dict(rel.f64)
        global_agg_items = [
            (e, a) for e, a in sel.items if isinstance(e, P.Agg)]
        if global_agg_items and not sel.group_by:
            # aggregate without GROUP BY → single-row aggregate on a constant
            # key (q5's maxn, q7's maxprice), made on the column's device
            first_col = rel.columns[0]
            with_const = Project(plan, tuple(
                [(c, c) for c in rel.columns]
                + [("__g", lambda cols, fc=first_col:
                    torch.zeros_like(cols[fc], dtype=torch.int32))]))
            aggs = []
            projections = []
            for e, alias in sel.items:
                name = alias or _expr_name(e)
                argc = e.arg.name if isinstance(e.arg, P.Col) else None
                fn = {"count": "count"}.get(e.fn, e.fn)
                aggs.append((None if fn == "count" else argc, fn, name))
                projections.append((name, name))
            agg_node = Aggregate(with_const, group_keys=("__g",),
                                 aggs=tuple(aggs), out_capacity=8)
            out = LoweredRel(
                plan=Project(agg_node, tuple(projections)),
                columns=[n for n, _ in projections],
                single_row=True,
                unique_keys={n for n, _ in projections},
                base_relations=rel.base_relations,
            )
            return out

        for e, alias in sel.items:
            if isinstance(e, P.WindowFn):
                name = rank_aliases[id(e)]
                names.append(name)
                exprs.append((name, name))
                continue
            name = alias or _expr_name(e) or f"_c{self._anon}"
            self._anon += 1
            if isinstance(e, P.Col):
                exprs.append((name, e.name))
            else:
                exprs.append((name, _compile_expr(e, rel.dictionaries)))
                # float-literal money math: carry the integer basis for the
                # sink's exact f64 recompute
                if (isinstance(e, P.BinOp) and e.op == "*"
                        and isinstance(e.left, P.Lit)
                        and isinstance(e.left.value, float)
                        and isinstance(e.right, P.Col)):
                    basis = f"__basis_{name}"
                    exprs.append((basis, e.right.name))
                    f64[name] = ("mul_lit", e.left.value, basis)
            names.append(name)

        if sel.star:
            exprs = tuple((c, c) for c in rel.columns) + tuple(exprs)
            names = list(rel.columns) + names

        exprs = tuple(exprs)
        out = LoweredRel(**{**rel.__dict__})
        out.plan = Project(plan, exprs)
        out.columns = [n for n, _ in exprs]
        out.f64 = f64
        # uniqueness facts follow COLUMNS, not names: an output name carries
        # a key's (hard-)uniqueness only when it is a passthrough of that
        # key (a projection that aliases some other column onto a
        # hard-unique key's NAME must not inherit its unique_build license)
        out.unique_keys = {n for n, src in exprs
                           if isinstance(src, str) and src in rel.unique_keys}
        out.hard_unique_keys = {
            n for n, src in exprs
            if isinstance(src, str) and src in rel.hard_unique_keys}
        return out


def sql_to_spec(sql: str, catalog: Catalog, number: int = -99,
                window: tuple = ("elementwise",)) -> QuerySpec:
    """Parse + lower SQL into an executable QuerySpec (the port's
    ``QuerySpec`` and ``Schema``, ``f64_recompute`` included)."""
    rel = Lowerer(catalog).lower_select(P.parse_sql(sql))
    visible = [c for c in rel.columns if not c.startswith("__")]
    schema = Schema(
        names=visible,
        dictionaries={k: v for k, v in rel.dictionaries.items()
                      if k in visible},
        timestamp_cols=tuple(c for c in visible if c in rel.timestamp_cols),
        f64_recompute=rel.f64,
    )
    return QuerySpec(number=number, plan=rel.plan, window=window,
                     relations=tuple(sorted(rel.base_relations)),
                     schema=schema)
