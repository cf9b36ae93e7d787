"""SQL tokenizer and recursive-descent parser for the engine's dialect — a
copy of ``flock_tpu/sql/parser.py`` (the tokenizer, the AST dataclasses,
``Parser`` and ``parse_sql``), whole and unchanged: it is pure Python.

Reference counterpart: Flock's Query::plan() hands SQL to DataFusion's parser
(flock/src/query.rs:171-186).  This parser covers the dialect the NEXMark/YSB
suite actually executes (benchmarks/src/nexmark/query/*.sql, ysb.sql):

  SELECT [*|expr [AS alias], …]
  FROM table | (subquery) AS alias | T1 [INNER] JOIN T2 ON a = b [AND c = d]
  [WHERE conjunctions of =, <>, <, <=, >, >=, %, BETWEEN, OR-groups]
  [GROUP BY col, …]  [ORDER BY col [DESC], …]
  aggregates Count(*)/Count/Sum/Min/Max/Avg and
  Row_number() OVER (PARTITION BY col ORDER BY col [DESC|ASC])

Case-insensitive keywords; qualified names (``B.bidder``) resolve by column
name.  Produces a plain AST (dataclasses below) for sql/lower.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


# -- AST ---------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Lit:
    value: object  # int | float | str


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * / % = != < <= > >= AND OR
    left: object
    right: object


@dataclass(frozen=True)
class Between:
    expr: object
    low: object
    high: object


@dataclass(frozen=True)
class Agg:
    fn: str           # count/sum/min/max/avg
    arg: object       # Col or None (Count(*))


@dataclass(frozen=True)
class WindowFn:
    fn: str                      # row_number
    partition_by: tuple[str, ...]
    order_by: tuple[tuple[str, bool], ...]  # (col, descending)


@dataclass(frozen=True)
class Star:
    pass


@dataclass
class TableRef:
    name: str | None = None          # base table
    subquery: "Select" = None        # or derived table
    alias: str | None = None


@dataclass
class JoinClause:
    left: TableRef
    right: TableRef
    on: list[tuple[str, str]] = field(default_factory=list)  # equalities


@dataclass
class Select:
    items: list[tuple[object, str | None]] = field(default_factory=list)
    star: bool = False
    from_: object = None             # TableRef | JoinClause
    where: object = None             # expr or None
    group_by: list[str] = field(default_factory=list)
    order_by: list[tuple[str, bool]] = field(default_factory=list)


# -- tokenizer ---------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'[^']*')
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*(\.[A-Za-z_][A-Za-z_0-9]*)?)
  | (?P<op><>|!=|>=|<=|=|<|>|\+|-|\*|/|%|\(|\)|,|;)
""", re.X)

KEYWORDS = {
    "select", "from", "where", "group", "by", "as", "join", "inner", "on",
    "and", "or", "between", "order", "desc", "asc", "over", "partition",
    "not", "rows",
}


def tokenize(sql: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"bad token at: {sql[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue
        text = m.group()
        if m.lastgroup == "num":
            out.append(("num", text))
        elif m.lastgroup == "str":
            out.append(("str", text[1:-1]))
        elif m.lastgroup == "id":
            low = text.lower()
            out.append(("kw", low) if low in KEYWORDS else ("id", text))
        else:
            out.append(("op", text))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, k=0):
        return self.toks[self.i + k] if self.i + k < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind, val=None):
        t = self.peek()
        if t[0] == kind and (val is None or t[1].lower() == val):
            self.i += 1
            return t
        return None

    def expect(self, kind, val=None):
        t = self.accept(kind, val)
        if t is None:
            raise SyntaxError(f"expected {val or kind}, got {self.peek()}")
        return t

    # -- grammar ------------------------------------------------------------
    def parse(self) -> Select:
        sel = self.select()
        self.accept("op", ";")
        return sel

    def select(self) -> Select:
        self.expect("kw", "select")
        sel = Select()
        if self.accept("op", "*"):
            sel.star = True
            while self.accept("op", ","):
                e = self.expr()
                alias = self.alias_opt()
                sel.items.append((e, alias))
        else:
            while True:
                e = self.expr()
                alias = self.alias_opt()
                sel.items.append((e, alias))
                if not self.accept("op", ","):
                    break
        self.expect("kw", "from")
        sel.from_ = self.from_clause()
        if self.accept("kw", "where"):
            sel.where = self.expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            sel.group_by = self.col_list()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                c = self.colname()
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                sel.order_by.append((c, desc))
                if not self.accept("op", ","):
                    break
        return sel

    def alias_opt(self):
        if self.accept("kw", "as"):
            return self.next()[1]
        # bare alias (identifier not followed by '.'), e.g. "FROM bid B"
        if self.peek()[0] == "id" and self.peek(1)[1] not in ("(",):
            nxt = self.peek(1)
            if nxt[0] in ("op", "kw", "eof") and nxt[1] not in ("(", "."):
                pass  # only treat as alias in from_clause
        return None

    def table_ref(self) -> TableRef:
        if self.accept("op", "("):
            sub = self.select()
            self.expect("op", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.next()[1]
            elif self.peek()[0] == "id":
                alias = self.next()[1]
            return TableRef(subquery=sub, alias=alias)
        name = self.expect("id")[1]
        alias = None
        if self.accept("kw", "as"):
            alias = self.next()[1]
        elif self.peek()[0] == "id":
            alias = self.next()[1]
        return TableRef(name=name.lower(), alias=alias)

    def from_clause(self):
        left = self.table_ref()
        if self.accept("kw", "inner"):
            self.expect("kw", "join")
        elif not self.accept("kw", "join"):
            # "FROM a, b" (implicit cross join with WHERE equality — q4/q6 use
            # explicit JOIN in executed SQL; treat comma as join with ON from
            # WHERE during lowering if it ever appears)
            return left
        right = self.table_ref()
        self.expect("kw", "on")
        on = []
        while True:
            l = self.colname()
            self.expect("op", "=")
            r = self.colname()
            on.append((l, r))
            if not self.accept("kw", "and"):
                break
        return JoinClause(left, right, on)

    def col_list(self) -> list[str]:
        cols = [self.colname()]
        while self.accept("op", ","):
            cols.append(self.colname())
        return cols

    def colname(self) -> str:
        t = self.expect("id")[1]
        return t.split(".")[-1].lower()

    # expressions with precedence: OR < AND < cmp/BETWEEN < add < mul < unary
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = BinOp("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.cmp_expr()
        while self.accept("kw", "and"):
            e = BinOp("and", e, self.cmp_expr())
        return e

    def cmp_expr(self):
        e = self.add_expr()
        if self.accept("kw", "between"):
            lo = self.add_expr()
            self.expect("kw", "and")
            hi = self.add_expr()
            return Between(e, lo, hi)
        t = self.peek()
        if t[0] == "op" and t[1] in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"<>": "!="}.get(t[1], t[1])
            return BinOp(op, e, self.add_expr())
        return e

    def add_expr(self):
        e = self.mul_expr()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("+", "-"):
                self.next()
                e = BinOp(t[1], e, self.mul_expr())
            else:
                return e

    def mul_expr(self):
        e = self.unary()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("*", "/", "%"):
                self.next()
                e = BinOp(t[1], e, self.unary())
            else:
                return e

    def unary(self):
        if self.accept("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        t = self.peek()
        if t[0] == "num":
            self.next()
            return Lit(float(t[1]) if "." in t[1] else int(t[1]))
        if t[0] == "str":
            self.next()
            return Lit(t[1])
        if t[0] == "op" and t[1] == "*":
            self.next()
            return Star()
        if t[0] == "id":
            name = self.next()[1]
            base = name.split(".")[-1]
            low = base.lower()
            if self.accept("op", "("):
                if low in ("count", "sum", "min", "max", "avg"):
                    if self.accept("op", "*"):
                        arg = None
                    else:
                        arg = self.expr()
                    self.expect("op", ")")
                    return Agg(low, arg)
                if low == "row_number":
                    self.expect("op", ")")
                    return self.window_over()
                raise SyntaxError(f"unknown function {name}")
            return Col(low)
        raise SyntaxError(f"unexpected token {t}")

    def window_over(self) -> WindowFn:
        self.expect("kw", "over")
        self.expect("op", "(")
        part, order = [], []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            part = self.col_list()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                c = self.colname()
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order.append((c, desc))
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        return WindowFn("row_number", tuple(part), tuple(order))


def parse_sql(sql: str) -> Select:
    return Parser(sql).parse()
