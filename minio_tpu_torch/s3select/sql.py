"""S3 Select SQL engine — full expression dialect.

Round-3 rebuild of the round-2 subset into the reference's query surface
(MinIO internal/s3select/sql: parser.go grammar, funceval.go
functions, evaluate.go semantics, aggregation.go):

    SELECT */exprs [AS alias] FROM S3Object[.path] [alias] [WHERE expr] [LIMIT n]

Expressions: OR/AND/NOT; =, !=, <>, <, <=, >, >=; LIKE [ESCAPE], IN (...),
BETWEEN x AND y (all NOT-able); IS [NOT] NULL / MISSING; arithmetic
+ - * / %; string concat ||; CASE WHEN; JSON path steps (s.a.b[2].c).
Functions: CAST, SUBSTRING, TRIM, UPPER, LOWER, CHAR_LENGTH/
CHARACTER_LENGTH/LENGTH, COALESCE, NULLIF, UTCNOW, TO_STRING,
TO_TIMESTAMP, DATE_ADD, DATE_DIFF, EXTRACT. Aggregates: COUNT(*),
COUNT/SUM/AVG/MIN/MAX(expr).

NULL vs MISSING follow the reference: MISSING is an absent key, NULL an
explicit null; comparisons with either are UNKNOWN (three-valued logic)
and WHERE keeps only TRUE rows. Unaliased projected expressions name as
_1, _2, ... like AWS.

Records are dicts (CSV row by header or _N positions, JSON object).
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass, field


class SQLError(Exception):
    pass


class _Missing:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return "MISSING"


MISSING = _Missing()

# ------------------------------------------------------------------ lexer

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<number>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|\.\d+)
      | (?P<string>'(?:[^']|'')*')
      | (?P<qident>"(?:[^"]|"")*")
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op><=|>=|!=|<>|\|\||=|<|>|\(|\)|\[|\]|,|\.|\*|\+|-|/|%)
    )""",
    re.VERBOSE,
)


@dataclass
class _Tok:
    kind: str  # number | string | ident | qident | op
    text: str


def _tokenize(s: str) -> list[_Tok]:
    out, pos = [], 0
    n = len(s)
    while pos < n:
        if s[pos].isspace():
            pos += 1
            continue
        m = _TOKEN.match(s, pos)
        if not m or m.end() == pos:
            raise SQLError(f"bad token at {s[pos:pos + 20]!r}")
        for kind in ("number", "string", "qident", "ident", "op"):
            t = m.group(kind)
            if t is not None:
                out.append(_Tok(kind, t))
                break
        pos = m.end()
    return out


# ------------------------------------------------------------------- AST


@dataclass
class Lit:
    value: object


@dataclass
class Col:
    path: list  # str names and int indexes, alias already stripped


@dataclass
class Star:
    pass


@dataclass
class Unary:
    op: str  # NOT | NEG
    e: object


@dataclass
class Binary:
    op: str
    l: object
    r: object


@dataclass
class Like:
    e: object
    pat: object
    esc: object  # expr or None
    neg: bool


@dataclass
class InList:
    e: object
    items: list
    neg: bool


@dataclass
class Between:
    e: object
    lo: object
    hi: object
    neg: bool


@dataclass
class Is:
    e: object
    what: str  # NULL | MISSING | TRUE | FALSE
    neg: bool


@dataclass
class Case:
    whens: list  # [(cond, result)]
    else_: object
    operand: object = None  # CASE x WHEN v THEN ... form


@dataclass
class Cast:
    e: object
    type: str


@dataclass
class Func:
    name: str
    args: list
    extra: dict = field(default_factory=dict)


@dataclass
class Agg:
    fn: str  # COUNT | SUM | AVG | MIN | MAX
    arg: object  # expr or Star
    idx: int = 0


@dataclass
class Query:
    items: list = field(default_factory=list)  # [(expr|Star, name|None)]
    aggregates: list = field(default_factory=list)  # Agg nodes in items order
    where: object = None
    limit: int = -1
    alias: str = "s3object"


AGG_FNS = ("COUNT", "SUM", "AVG", "MIN", "MAX")
SCALAR_FNS = (
    "CAST", "SUBSTRING", "TRIM", "UPPER", "LOWER", "CHAR_LENGTH",
    "CHARACTER_LENGTH", "LENGTH", "COALESCE", "NULLIF", "UTCNOW",
    "TO_STRING", "TO_TIMESTAMP", "DATE_ADD", "DATE_DIFF", "EXTRACT",
)
CAST_TYPES = (
    "INT", "INTEGER", "FLOAT", "DOUBLE", "DECIMAL", "NUMERIC", "STRING",
    "VARCHAR", "CHAR", "BOOL", "BOOLEAN", "TIMESTAMP",
)
DATE_PARTS = ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND")


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, off: int = 0) -> _Tok | None:
        j = self.i + off
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise SQLError("unexpected end of query")
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "ident" and t.text.upper() in kws

    def eat_kw(self, kw: str) -> bool:
        if self.at_kw(kw):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            t = self.peek()
            raise SQLError(f"expected {kw}, got {t.text if t else 'EOF'!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "op" and t.text in ops

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            t = self.peek()
            raise SQLError(f"expected {op!r}, got {t.text if t else 'EOF'!r}")

    # -- grammar -----------------------------------------------------------

    def parse_query(self) -> Query:
        self.expect_kw("SELECT")
        q = Query()
        # select list
        while True:
            if self.at_op("*") and not q.items:
                self.next()
                q.items.append((Star(), None))
            else:
                e = self.parse_expr()
                name = None
                if self.eat_kw("AS"):
                    t = self.next()
                    if t.kind not in ("ident", "qident"):
                        raise SQLError("expected alias after AS")
                    name = t.text.strip('"')
                elif self.peek() is not None and self.peek().kind in ("ident", "qident") \
                        and not self.at_kw("FROM"):
                    name = self.next().text.strip('"')
                q.items.append((e, name))
            if not self.eat_op(","):
                break
        self.expect_kw("FROM")
        t = self.next()
        if t.kind != "ident" or t.text.lower() != "s3object":
            raise SQLError("FROM must reference S3Object")
        # optional .path after S3Object (document-path FROM; we accept and
        # ignore leading [*] style steps) and optional alias
        while self.at_op("."):
            self.next()
            self.next()  # path step, unsupported deep-FROM: tolerated
        if self.at_op("["):
            while not self.eat_op("]"):
                self.next()
        if self.peek() is not None and self.peek().kind == "ident" \
                and not self.at_kw("WHERE", "LIMIT"):
            q.alias = self.next().text.lower()
        if self.eat_kw("WHERE"):
            q.where = self.parse_expr()
        if self.eat_kw("LIMIT"):
            t = self.next()
            if t.kind != "number":
                raise SQLError("LIMIT expects a number")
            q.limit = int(float(t.text))
        if self.peek() is not None:
            raise SQLError(f"trailing tokens at {self.peek().text!r}")
        # collect aggregates; reject aggregate-in-WHERE
        for e, _name in q.items:
            _collect_aggs(e, q.aggregates)
        if q.where is not None:
            tmp: list = []
            _collect_aggs(q.where, tmp)
            if tmp:
                raise SQLError("aggregate functions are not allowed in WHERE")
        if q.aggregates:
            # AWS allows ONLY aggregate expressions alongside aggregates
            # (a * projection included)
            for e, _ in q.items:
                if not isinstance(e, Agg):
                    raise SQLError("cannot mix aggregate and non-aggregate projections")
        for k, a in enumerate(q.aggregates):
            a.idx = k
        return q

    # expression precedence: OR < AND < NOT < comparison/IS/LIKE/IN/BETWEEN
    # < additive (+ - ||) < multiplicative (* / %) < unary - < primary
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.at_kw("OR"):
            self.next()
            e = Binary("OR", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.at_kw("AND"):
            self.next()
            e = Binary("AND", e, self.parse_not())
        return e

    def parse_not(self):
        if self.at_kw("NOT"):
            self.next()
            return Unary("NOT", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        e = self.parse_add()
        while True:
            neg = False
            save = self.i
            if self.at_kw("NOT"):
                self.next()
                if not self.at_kw("LIKE", "IN", "BETWEEN"):
                    self.i = save
                    return e
                neg = True
            if self.at_op("=", "!=", "<>", "<", "<=", ">", ">="):
                op = self.next().text
                e = Binary("<>" if op == "!=" else op, e, self.parse_add())
            elif self.at_kw("LIKE"):
                self.next()
                pat = self.parse_add()
                esc = self.parse_add() if self.eat_kw("ESCAPE") else None
                e = Like(e, pat, esc, neg)
            elif self.at_kw("IN"):
                self.next()
                self.expect_op("(")
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                e = InList(e, items, neg)
            elif self.at_kw("BETWEEN"):
                self.next()
                lo = self.parse_add()
                self.expect_kw("AND")
                e = Between(e, lo, self.parse_add(), neg)
            elif self.at_kw("IS"):
                self.next()
                isneg = self.eat_kw("NOT")
                t = self.next()
                what = t.text.upper()
                if what not in ("NULL", "MISSING", "TRUE", "FALSE"):
                    raise SQLError("expected NULL/MISSING/TRUE/FALSE after IS")
                e = Is(e, what, isneg)
            else:
                if neg:
                    raise SQLError("expected LIKE/IN/BETWEEN after NOT")
                return e

    def parse_add(self):
        e = self.parse_mul()
        while True:
            if self.at_op("+", "-"):
                op = self.next().text
                e = Binary(op, e, self.parse_mul())
            elif self.at_op("||"):
                self.next()
                e = Binary("||", e, self.parse_mul())
            else:
                return e

    def parse_mul(self):
        e = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            e = Binary(op, e, self.parse_unary())
        return e

    def parse_unary(self):
        if self.at_op("-"):
            self.next()
            return Unary("NEG", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t is None:
            raise SQLError("unexpected end of expression")
        if t.kind == "number":
            self.next()
            # ints parse exactly (no float round-trip: 2^53+ IDs must not
            # be silently corrupted); anything with . or e is a float
            if "." not in t.text and "e" not in t.text.lower():
                return Lit(int(t.text))
            return Lit(float(t.text))
        if t.kind == "string":
            self.next()
            return Lit(t.text[1:-1].replace("''", "'"))
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "qident":
            self.next()
            return self._path(t.text.strip('"'))
        if t.kind != "ident":
            raise SQLError(f"unexpected token {t.text!r}")
        up = t.text.upper()
        if up in ("TRUE", "FALSE"):
            self.next()
            return Lit(up == "TRUE")
        if up == "NULL":
            self.next()
            return Lit(None)
        if up == "MISSING":
            self.next()
            return Lit(MISSING)
        if up == "CASE":
            return self._case()
        if up in AGG_FNS and self._is_call():
            return self._agg(up)
        if up in SCALAR_FNS and (self._is_call() or up == "UTCNOW"):
            return self._func(up)
        self.next()
        return self._path(t.text)

    def _is_call(self) -> bool:
        nxt = self.peek(1)
        return nxt is not None and nxt.kind == "op" and nxt.text == "("

    def _path(self, first: str):
        steps: list = [first]
        while True:
            if self.eat_op("."):
                t = self.next()
                if t.kind == "op" and t.text == "*":
                    continue  # .* wildcard step: treated as identity
                if t.kind not in ("ident", "qident"):
                    raise SQLError("expected name after '.'")
                steps.append(t.text.strip('"'))
            elif self.at_op("["):
                self.next()
                t = self.next()
                if t.kind == "op" and t.text == "*":
                    self.expect_op("]")
                    continue
                if t.kind != "number":
                    raise SQLError("expected index in []")
                self.expect_op("]")
                steps.append(int(float(t.text)))
            else:
                return Col(steps)

    def _case(self):
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("WHEN"):
            c = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((c, self.parse_expr()))
        if not whens:
            raise SQLError("CASE needs at least one WHEN")
        else_ = self.parse_expr() if self.eat_kw("ELSE") else Lit(None)
        self.expect_kw("END")
        return Case(whens, else_, operand)

    def _agg(self, fn: str):
        self.next()  # fn name
        self.expect_op("(")
        if fn == "COUNT" and self.at_op("*"):
            self.next()
            self.expect_op(")")
            return Agg("COUNT", Star())
        arg = self.parse_expr()
        self.expect_op(")")
        return Agg(fn, arg)

    def _func(self, fn: str):
        self.next()  # name
        if fn == "UTCNOW":
            if self.eat_op("("):
                self.expect_op(")")
            return Func("UTCNOW", [])
        self.expect_op("(")
        if fn == "CAST":
            e = self.parse_expr()
            self.expect_kw("AS")
            t = self.next()
            ty = t.text.upper()
            if ty not in CAST_TYPES:
                raise SQLError(f"unsupported CAST type {t.text!r}")
            self.expect_op(")")
            return Cast(e, ty)
        if fn == "SUBSTRING":
            e = self.parse_expr()
            if self.eat_kw("FROM"):
                start = self.parse_expr()
                length = self.parse_expr() if self.eat_kw("FOR") else None
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = self.parse_expr() if self.eat_op(",") else None
            self.expect_op(")")
            return Func("SUBSTRING", [e, start, length])
        if fn == "TRIM":
            mode = "BOTH"
            if self.at_kw("LEADING", "TRAILING", "BOTH"):
                mode = self.next().text.upper()
                if self.at_kw("FROM"):
                    self.next()
                    e = self.parse_expr()
                    self.expect_op(")")
                    return Func("TRIM", [e, Lit(None)], {"mode": mode})
                chars = self.parse_expr()
                self.expect_kw("FROM")
                e = self.parse_expr()
                self.expect_op(")")
                return Func("TRIM", [e, chars], {"mode": mode})
            e = self.parse_expr()
            if self.eat_kw("FROM"):
                # TRIM(chars FROM e)
                chars = e
                e = self.parse_expr()
                self.expect_op(")")
                return Func("TRIM", [e, chars], {"mode": mode})
            self.expect_op(")")
            return Func("TRIM", [e, Lit(None)], {"mode": mode})
        if fn == "EXTRACT":
            t = self.next()
            part = t.text.upper()
            if part not in DATE_PARTS:
                raise SQLError(f"bad date part {t.text!r}")
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return Func("EXTRACT", [e], {"part": part})
        if fn in ("DATE_ADD", "DATE_DIFF"):
            t = self.next()
            part = t.text.upper()
            if part not in DATE_PARTS:
                raise SQLError(f"bad date part {t.text!r}")
            self.expect_op(",")
            a = self.parse_expr()
            self.expect_op(",")
            b = self.parse_expr()
            self.expect_op(")")
            return Func(fn, [a, b], {"part": part})
        args = []
        if not self.at_op(")"):
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        return Func(fn, args)


def _collect_aggs(e, out: list) -> None:
    if isinstance(e, Agg):
        out.append(e)
        return
    if isinstance(e, (Lit, Col, Star)) or e is None:
        return
    if isinstance(e, Unary):
        _collect_aggs(e.e, out)
    elif isinstance(e, Binary):
        _collect_aggs(e.l, out)
        _collect_aggs(e.r, out)
    elif isinstance(e, Like):
        for x in (e.e, e.pat, e.esc):
            _collect_aggs(x, out)
    elif isinstance(e, InList):
        _collect_aggs(e.e, out)
        for x in e.items:
            _collect_aggs(x, out)
    elif isinstance(e, Between):
        for x in (e.e, e.lo, e.hi):
            _collect_aggs(x, out)
    elif isinstance(e, Is):
        _collect_aggs(e.e, out)
    elif isinstance(e, Case):
        _collect_aggs(e.operand, out)
        for c, r in e.whens:
            _collect_aggs(c, out)
            _collect_aggs(r, out)
        _collect_aggs(e.else_, out)
    elif isinstance(e, Cast):
        _collect_aggs(e.e, out)
    elif isinstance(e, Func):
        for x in e.args:
            _collect_aggs(x, out)


def parse(expr: str) -> Query:
    try:
        return _Parser(_tokenize(expr)).parse_query()
    except SQLError:
        raise
    except (IndexError, ValueError, AttributeError) as e:
        raise SQLError(f"malformed query: {e}") from None


# -------------------------------------------------------------- evaluator


def _num(v):
    """Coerce to a number, else None (dynamic typing over CSV strings)."""
    if isinstance(v, bool) or v is None or v is MISSING:
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f.is_integer() and "." not in v and "e" not in v.lower() else f
        except ValueError:
            return None
    return None


def _is_null(v) -> bool:
    return v is None or v is MISSING


_TS_FORMATS = (
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M%z",
    "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H:%M",
    "%Y-%m-%d", "%Y-%m-%dT",
)


def _to_ts(v):
    if isinstance(v, _dt.datetime):
        return v
    if not isinstance(v, str):
        return None
    s = v.strip().replace("Z", "+00:00").replace("z", "+00:00")
    for fmt in _TS_FORMATS:
        try:
            ts = _dt.datetime.strptime(s, fmt)
            if ts.tzinfo is None:
                ts = ts.replace(tzinfo=_dt.timezone.utc)
            return ts
        except ValueError:
            continue
    return None


_TS_TOKENS = re.compile(r"yyyy|yy|MM|M|dd|d|HH|H|hh|h|mm|m|ss|s|a")
_TS_MAP = {
    "yyyy": "%Y", "yy": "%y", "MM": "%m", "M": "%-m", "dd": "%d", "d": "%-d",
    "HH": "%H", "H": "%-H", "hh": "%I", "h": "%-I", "mm": "%M", "m": "%-M",
    "ss": "%S", "s": "%-S", "a": "%p",
}


def _fmt_ts(ts: _dt.datetime, pattern: str | None) -> str:
    if not pattern:
        return ts.isoformat()
    # Ion/Java-style pattern subset (reference funceval.go TO_STRING);
    # single-pass longest-token substitution so emitted strftime codes are
    # never re-matched
    out = _TS_TOKENS.sub(lambda m: _TS_MAP[m.group(0)], pattern)
    try:
        return ts.strftime(out)
    except ValueError:
        return ts.isoformat()


class _Env:
    __slots__ = ("record", "alias")

    def __init__(self, record: dict, alias: str):
        self.record = record
        self.alias = alias


def _resolve(env: _Env, path: list):
    steps = list(path)
    if steps and isinstance(steps[0], str) and steps[0].lower() in (
        env.alias, "s3object"
    ):
        steps = steps[1:]
        if not steps:
            return env.record
    cur = env.record
    for j, st in enumerate(steps):
        if isinstance(st, int):
            if isinstance(cur, list) and 0 <= st < len(cur):
                cur = cur[st]
            else:
                return MISSING
            continue
        if not isinstance(cur, dict):
            return MISSING
        if st in cur:
            cur = cur[st]
            continue
        # case-insensitive fallback (CSV headers)
        lk = st.lower()
        for k, v in cur.items():
            if k.lower() == lk:
                cur = v
                break
        else:
            return MISSING
    return cur


def _cmp_vals(op: str, a, b):
    """Three-valued comparison: None result = UNKNOWN."""
    if _is_null(a) or _is_null(b):
        return None
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None and not (
        isinstance(a, str) and isinstance(b, str)
    ):
        a, b = na, nb
    elif isinstance(a, _dt.datetime) or isinstance(b, _dt.datetime):
        a, b = _to_ts(a), _to_ts(b)
        if a is None or b is None:
            return None
    else:
        a, b = str(a), str(b)
    try:
        if op == "=":
            return a == b
        if op == "<>":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except TypeError:
        return None
    return None


def _like(v, pat, esc) -> bool | None:
    if _is_null(v) or _is_null(pat):
        return None
    v, pat = str(v), str(pat)
    e = str(esc) if esc not in (None, MISSING) else None
    if e is not None and len(e) != 1:
        raise SQLError("ESCAPE must be a single character")
    rx = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if e is not None and c == e and i + 1 < len(pat):
            rx.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            rx.append(".*")
        elif c == "_":
            rx.append(".")
        else:
            rx.append(re.escape(c))
        i += 1
    return re.fullmatch("".join(rx), v, re.DOTALL) is not None


def _eval(e, env: _Env):
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, Col):
        return _resolve(env, e.path)
    if isinstance(e, Star):
        return env.record
    if isinstance(e, Unary):
        if e.op == "NOT":
            v = _truth(_eval(e.e, env))
            return None if v is None else (not v)
        v = _num(_eval(e.e, env))
        return None if v is None else -v
    if isinstance(e, Binary):
        return _eval_binary(e, env)
    if isinstance(e, Like):
        r = _like(_eval(e.e, env), _eval(e.pat, env),
                  _eval(e.esc, env) if e.esc is not None else None)
        if r is None:
            return None
        return (not r) if e.neg else r
    if isinstance(e, InList):
        v = _eval(e.e, env)
        if _is_null(v):
            return None
        saw_unknown = False
        for item in e.items:
            r = _cmp_vals("=", v, _eval(item, env))
            if r is True:
                return not e.neg
            if r is None:
                saw_unknown = True
        return None if saw_unknown else e.neg
    if isinstance(e, Between):
        v = _eval(e.e, env)
        lo = _cmp_vals(">=", v, _eval(e.lo, env))
        hi = _cmp_vals("<=", v, _eval(e.hi, env))
        if lo is None or hi is None:
            return None
        r = lo and hi
        return (not r) if e.neg else r
    if isinstance(e, Is):
        v = _eval(e.e, env)
        if e.what == "MISSING":
            r = v is MISSING
        elif e.what == "NULL":
            r = _is_null(v)  # reference: MISSING IS NULL is also true
        elif e.what == "TRUE":
            r = v is True
        else:
            r = v is False
        return (not r) if e.neg else r
    if isinstance(e, Case):
        if e.operand is not None:
            base = _eval(e.operand, env)
            for c, res in e.whens:
                if _cmp_vals("=", base, _eval(c, env)) is True:
                    return _eval(res, env)
        else:
            for c, res in e.whens:
                if _truth(_eval(c, env)) is True:
                    return _eval(res, env)
        return _eval(e.else_, env)
    if isinstance(e, Cast):
        return _cast(_eval(e.e, env), e.type)
    if isinstance(e, Func):
        return _eval_func(e, env)
    if isinstance(e, Agg):  # evaluated only via aggregation state
        raise SQLError("aggregate in scalar context")
    raise SQLError(f"unsupported expression {e!r}")


def _truth(v):
    if _is_null(v):
        return None
    if isinstance(v, bool):
        return v
    return None  # non-boolean in boolean context: UNKNOWN


def _eval_binary(e: Binary, env: _Env):
    if e.op == "AND":
        l = _truth(_eval(e.l, env))
        if l is False:
            return False
        r = _truth(_eval(e.r, env))
        if r is False:
            return False
        return None if l is None or r is None else True
    if e.op == "OR":
        l = _truth(_eval(e.l, env))
        if l is True:
            return True
        r = _truth(_eval(e.r, env))
        if r is True:
            return True
        return None if l is None or r is None else False
    if e.op in ("=", "<>", "<", "<=", ">", ">="):
        return _cmp_vals(e.op, _eval(e.l, env), _eval(e.r, env))
    if e.op == "||":
        a, b = _eval(e.l, env), _eval(e.r, env)
        if _is_null(a) or _is_null(b):
            return None
        return _stringify(a) + _stringify(b)
    a, b = _num(_eval(e.l, env)), _num(_eval(e.r, env))
    if a is None or b is None:
        return None
    if e.op == "+":
        return a + b
    if e.op == "-":
        return a - b
    if e.op == "*":
        return a * b
    if e.op == "/":
        if b == 0:
            raise SQLError("division by zero")
        r = a / b
        return int(r) if isinstance(a, int) and isinstance(b, int) and a % b == 0 else r
    if e.op == "%":
        if b == 0:
            raise SQLError("division by zero")
        return a % b
    raise SQLError(f"unsupported operator {e.op}")


def _stringify(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, _dt.datetime):
        return v.isoformat()
    return str(v)


def _cast(v, ty: str):
    if _is_null(v):
        return None
    try:
        if ty in ("INT", "INTEGER"):
            if isinstance(v, str):
                return int(float(v.strip()))
            return int(v)
        if ty in ("FLOAT", "DOUBLE", "DECIMAL", "NUMERIC"):
            return float(v)
        if ty in ("STRING", "VARCHAR", "CHAR"):
            return _stringify(v)
        if ty in ("BOOL", "BOOLEAN"):
            if isinstance(v, bool):
                return v
            s = str(v).strip().lower()
            if s in ("true", "1"):
                return True
            if s in ("false", "0"):
                return False
            raise ValueError(s)
        if ty == "TIMESTAMP":
            ts = _to_ts(v)
            if ts is None:
                raise ValueError(str(v))
            return ts
    except (TypeError, ValueError) as exc:
        raise SQLError(f"cannot CAST {v!r} to {ty}: {exc}") from None
    raise SQLError(f"unsupported CAST type {ty}")


def _eval_func(e: Func, env: _Env):
    fn = e.name
    if fn == "UTCNOW":
        return _dt.datetime.now(_dt.timezone.utc)
    if fn == "COALESCE":
        for a in e.args:
            v = _eval(a, env)
            if not _is_null(v):
                return v
        return None
    if fn == "NULLIF":
        if len(e.args) != 2:
            raise SQLError("NULLIF takes 2 arguments")
        a, b = _eval(e.args[0], env), _eval(e.args[1], env)
        return None if _cmp_vals("=", a, b) is True else a
    if fn in ("UPPER", "LOWER"):
        v = _eval(e.args[0], env)
        if _is_null(v):
            return None
        s = _stringify(v)
        return s.upper() if fn == "UPPER" else s.lower()
    if fn in ("CHAR_LENGTH", "CHARACTER_LENGTH", "LENGTH"):
        v = _eval(e.args[0], env)
        return None if _is_null(v) else len(_stringify(v))
    if fn == "SUBSTRING":
        v = _eval(e.args[0], env)
        if _is_null(v):
            return None
        s = _stringify(v)
        start = _num(_eval(e.args[1], env))
        if start is None:
            return None
        start = int(start)
        length = None
        if e.args[2] is not None:
            length = _num(_eval(e.args[2], env))
            if length is None:
                return None
            length = int(length)
            if length < 0:
                raise SQLError("SUBSTRING length must be >= 0")
        # SQL semantics: positions are 1-based; a start before 1 consumes
        # length toward position 1 (reference funceval.go substring)
        end = len(s) + 1 if length is None else start + length
        lo = max(start, 1)
        hi = max(end, 1)
        return s[lo - 1:hi - 1]
    if fn == "TRIM":
        v = _eval(e.args[0], env)
        if _is_null(v):
            return None
        s = _stringify(v)
        chars_v = _eval(e.args[1], env) if len(e.args) > 1 else None
        chars = None if _is_null(chars_v) else _stringify(chars_v)
        mode = e.extra.get("mode", "BOTH")
        if mode == "LEADING":
            return s.lstrip(chars)
        if mode == "TRAILING":
            return s.rstrip(chars)
        return s.strip(chars)
    if fn == "TO_STRING":
        ts = _to_ts(_eval(e.args[0], env))
        if ts is None:
            return None
        pattern = None
        if len(e.args) > 1:
            pv = _eval(e.args[1], env)
            pattern = None if _is_null(pv) else str(pv)
        return _fmt_ts(ts, pattern)
    if fn == "TO_TIMESTAMP":
        return _to_ts(_eval(e.args[0], env))
    if fn == "EXTRACT":
        ts = _to_ts(_eval(e.args[0], env))
        if ts is None:
            return None
        part = e.extra["part"]
        return {"YEAR": ts.year, "MONTH": ts.month, "DAY": ts.day,
                "HOUR": ts.hour, "MINUTE": ts.minute, "SECOND": ts.second}[part]
    if fn == "DATE_ADD":
        n = _num(_eval(e.args[0], env))
        ts = _to_ts(_eval(e.args[1], env))
        if n is None or ts is None:
            return None
        n = int(n)
        part = e.extra["part"]
        if part == "YEAR":
            try:
                return ts.replace(year=ts.year + n)
            except ValueError:  # Feb 29 -> Feb 28
                return ts.replace(year=ts.year + n, day=28)
        if part == "MONTH":
            mo = ts.month - 1 + n
            yr = ts.year + mo // 12
            mo = mo % 12 + 1
            import calendar

            day = min(ts.day, calendar.monthrange(yr, mo)[1])
            return ts.replace(year=yr, month=mo, day=day)
        delta = {"DAY": _dt.timedelta(days=n), "HOUR": _dt.timedelta(hours=n),
                 "MINUTE": _dt.timedelta(minutes=n),
                 "SECOND": _dt.timedelta(seconds=n)}[part]
        return ts + delta
    if fn == "DATE_DIFF":
        a = _to_ts(_eval(e.args[0], env))
        b = _to_ts(_eval(e.args[1], env))
        if a is None or b is None:
            return None
        part = e.extra["part"]
        if part == "YEAR":
            return b.year - a.year
        if part == "MONTH":
            return (b.year - a.year) * 12 + (b.month - a.month)
        secs = (b - a).total_seconds()
        return int({"DAY": secs // 86400, "HOUR": secs // 3600,
                    "MINUTE": secs // 60, "SECOND": secs}[part])
    raise SQLError(f"unsupported function {fn}")


# ------------------------------------------------------------- execution


def _item_name(e, name: str | None, pos: int) -> str:
    if name:
        return name
    if isinstance(e, Col):
        for st in reversed(e.path):
            if isinstance(st, str):
                return st
    if isinstance(e, Agg):
        return f"_{pos}"
    return f"_{pos}"


def _json_safe(v):
    if v is MISSING:
        return None
    if isinstance(v, _dt.datetime):
        return v.isoformat()
    return v


def execute(q: Query, records) -> tuple[list[dict], dict | None]:
    """(projected rows, aggregate row|None)."""
    out: list[dict] = []
    if q.aggregates:
        states = [
            {"count": 0, "sum": 0.0, "min": None, "max": None, "numeric": 0}
            for _ in q.aggregates
        ]
        for rec in records:
            env = _Env(rec, q.alias)
            if q.where is not None and _truth(_eval(q.where, env)) is not True:
                continue
            for a, st in zip(q.aggregates, states):
                if isinstance(a.arg, Star):
                    st["count"] += 1
                    continue
                v = _eval(a.arg, env)
                if _is_null(v):
                    continue
                st["count"] += 1
                x = _num(v)
                if x is not None:
                    st["numeric"] += 1
                    st["sum"] += x
                    st["min"] = x if st["min"] is None else min(st["min"], x)
                    st["max"] = x if st["max"] is None else max(st["max"], x)
        row: dict = {}
        for pos, (e, name) in enumerate(q.items, 1):
            if not isinstance(e, Agg):
                continue
            st = states[e.idx]
            key = name or f"_{pos}"
            if e.fn == "COUNT":
                row[key] = st["count"]
            elif e.fn == "SUM":
                row[key] = st["sum"] if st["numeric"] else None
            elif e.fn == "AVG":
                row[key] = st["sum"] / st["numeric"] if st["numeric"] else None
            elif e.fn == "MIN":
                row[key] = st["min"]
            elif e.fn == "MAX":
                row[key] = st["max"]
        return [], row
    for rec in records:
        if 0 <= q.limit <= len(out):
            break
        env = _Env(rec, q.alias)
        if q.where is not None and _truth(_eval(q.where, env)) is not True:
            continue
        if len(q.items) == 1 and isinstance(q.items[0][0], Star):
            out.append(dict(rec))
        else:
            row = {}
            for pos, (e, name) in enumerate(q.items, 1):
                if isinstance(e, Star):
                    row.update(rec)
                    continue
                v = _eval(e, env)
                # MISSING stays in the row as the sentinel: the JSON
                # writer omits the key (AWS), the CSV writer emits an
                # empty field so columns stay aligned
                row[_item_name(e, name, pos)] = (
                    MISSING if v is MISSING else _json_safe(v)
                )
            out.append(row)
        if 0 <= q.limit <= len(out):
            break
    return out, None
