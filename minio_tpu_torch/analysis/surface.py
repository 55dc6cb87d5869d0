"""Observable-surface extraction (the ``surface`` interprocedural pass).

Statically extracts everything the binary exposes to an operator into
one canonical, JSON-serializable manifest:

- metrics series (name, type, labels, group, help) from every
  ``_fmt(...)`` registration site in server/metrics.py, the legacy v2
  ``Metrics.render`` exposition, and the worker-pool fan-out extras;
- admin routes from the ``handle_admin`` dispatch table, S3 routes from
  the aiohttp router registrations, STS actions from ``handle_sts``;
- obs trace types (declared constants + every publish site in the
  package);
- fault-injection boundaries/modes from ``fault/registry.py`` and every
  ``check(...)`` call site that consults them;
- the knob registry and the ``s3err`` error-code table.

The manifest is pure data: rules_surface.py turns it into findings
(reference parity, guardrail exhaustiveness) and minio_tpu_torch/docs/SURFACE.md.
Everything here is stdlib-only and driven off ``ProjectIndex.paths`` so
the pass sees exactly the tree being analyzed.
"""

from __future__ import annotations

import ast
import re

# files the structured extractors target (package-relative)
METRICS_FILE = "server/metrics.py"
APP_FILE = "server/app.py"
ADMIN_FILE = "server/admin.py"
STS_FILE = "server/sts.py"
TRACE_FILE = "obs/trace.py"
FAULT_FILE = "fault/registry.py"
S3ERR_FILE = "server/s3err.py"

_SERIES_RE = re.compile(r"^(minio_[a-z0-9_]+)")
_TYPE_LINE_RE = re.compile(r"#\s*TYPE\s+(minio_[a-z0-9_]+)\s+(\w+)")
_LABEL_KEY_RE = re.compile(r"(\w+)=\"?$")
_TYPE_CONST_RE = re.compile(r"\bTYPE_([A-Z0-9_]+)\b")
_RECORD_TYPE_RE = re.compile(r"[\"']type[\"']\s*:\s*[\"']([a-z0-9_-]+)[\"']")


def _read(index, relpath: str) -> str | None:
    path = index.paths.get(relpath)
    if path is None:
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


def _parse(index, relpath: str) -> ast.Module | None:
    src = _read(index, relpath)
    if src is None:
        return None
    try:
        return ast.parse(src, filename=relpath)
    except SyntaxError:
        return None


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# -- metrics ----------------------------------------------------------------


def _label_keys(node: ast.AST) -> list[str]:
    """Label-name union across every dict literal inside a ``_fmt``
    values expression (``[({"drive": p, "api": op}, v) ...]``)."""
    keys: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Dict):
            for k in sub.keys:
                s = _const_str(k)
                if s is not None:
                    keys.add(s)
    return sorted(keys)


class _FmtCollector(ast.NodeVisitor):
    """Collect ``_fmt(out, "name", "type", values[, help])`` calls inside
    one renderer, tracking whether each sits under a conditional."""

    def __init__(self):
        self.series: list[dict] = []
        self._cond_depth = 0
        self.has_guarded_return = False

    def _visit_cond(self, node, branches):
        self._cond_depth += 1
        for b in branches:
            for child in b:
                self.visit(child)
        self._cond_depth -= 1

    def visit_If(self, node: ast.If):
        for n in ast.walk(node):
            if isinstance(n, ast.Return):
                # `if x is None: return out` early-out guards the whole
                # renderer: everything below it is conditional too
                self.has_guarded_return = True
        self._visit_cond(node, [node.body, node.orelse])

    def visit_Try(self, node: ast.Try):
        for child in node.body:
            self.visit(child)
        self._visit_cond(
            node, [h.body for h in node.handlers] + [node.orelse]
        )
        for child in node.finalbody:
            self.visit(child)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "_fmt" and len(node.args) >= 4:
            name = _const_str(node.args[1])
            mtype = _const_str(node.args[2])
            if name:
                help_ = ""
                if len(node.args) >= 5:
                    help_ = _const_str(node.args[4]) or ""
                for kw in node.keywords:
                    if kw.arg == "help_":
                        help_ = _const_str(kw.value) or ""
                self.series.append({
                    "name": name,
                    "type": mtype or "untyped",
                    "labels": _label_keys(node.args[3]),
                    "help": help_,
                    "line": node.lineno,
                    "conditional": self._cond_depth > 0,
                })
        self.generic_visit(node)


def _v3_group_map(tree: ast.Module) -> tuple[dict, dict]:
    """renderer function name -> collector path, from the V3_GROUPS /
    V3_BUCKET_GROUPS dict literals."""
    groups: dict[str, str] = {}
    bucket_groups: dict[str, str] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id not in ("V3_GROUPS", "V3_BUCKET_GROUPS") or not isinstance(
            node.value, ast.Dict
        ):
            continue
        out = groups if tgt.id == "V3_GROUPS" else bucket_groups
        for k, v in zip(node.value.keys, node.value.values):
            path = _const_str(k)
            if path is not None and isinstance(v, ast.Name):
                out[v.id] = path
    return groups, bucket_groups


def _v2_series(fn: ast.FunctionDef) -> list[dict]:
    """Series in the legacy ``Metrics.render`` exposition: names come
    from ``# TYPE`` comment constants; labels from the literal text of
    the sample f-strings (constant parts end with ``label="``)."""
    types: dict[str, str] = {}
    labels: dict[str, set] = {}
    order: list[str] = []

    cond_of: dict[int, bool] = {}

    def scan(node, cond):
        for child in ast.iter_child_nodes(node):
            c = cond or isinstance(node, ast.If)
            cond_of[id(child)] = c
            scan(child, c)

    cond_of[id(fn)] = False
    scan(fn, False)

    for node in ast.walk(fn):
        consts: list[tuple[str, bool, int, str | None]] = []
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            consts.append((node.value, cond_of.get(id(node), False),
                           node.lineno, None))
        elif isinstance(node, ast.JoinedStr):
            parts = node.values
            for i, part in enumerate(parts):
                if isinstance(part, ast.Constant) and isinstance(
                    part.value, str
                ):
                    consts.append((part.value, cond_of.get(id(node), False),
                                   node.lineno, "fstr"))
        for text, cond, lineno, _src in consts:
            m = _TYPE_LINE_RE.search(text)
            if m:
                name = m.group(1)
                if name not in types:
                    types[name] = m.group(2)
                    order.append(name)
                    labels.setdefault(name, set())
                    cond_key = f"cond:{name}"
                    labels.setdefault(cond_key, set())
                    if cond:
                        labels[cond_key].add("y")
                continue
            m = _SERIES_RE.match(text)
            if m:
                name = m.group(1)
                labels.setdefault(name, set())
                for lm in re.finditer(r"(\w+)=\"", text):
                    labels[name].add(lm.group(1))
                if name not in types:
                    types[name] = "untyped"
                    order.append(name)
                if cond:
                    labels.setdefault(f"cond:{name}", set()).add("y")
    out = []
    for name in order:
        out.append({
            "name": name,
            "type": types[name],
            "labels": sorted(labels.get(name, ())),
            "help": "",
            "line": fn.lineno,
            "conditional": bool(labels.get(f"cond:{name}")),
        })
    return out


def extract_metrics(index) -> tuple[list[dict], dict]:
    """All metrics series with their owning v3 group ('/v2' for the
    legacy exposition, '/pool' for the worker fan-out extras)."""
    tree = _parse(index, METRICS_FILE)
    if tree is None:
        return [], {}
    groups, bucket_groups = _v3_group_map(tree)
    series: list[dict] = []
    group_info: dict[str, dict] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Metrics":
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name == "render":
                    for s in _v2_series(sub):
                        s["group"] = "/v2"
                        s["file"] = METRICS_FILE
                        series.append(s)
                    group_info["/v2"] = {
                        "renderer": "Metrics.render", "bucket": False,
                        "line": sub.lineno,
                    }
        if not isinstance(node, ast.FunctionDef):
            continue
        gpath = groups.get(node.name) or bucket_groups.get(node.name)
        if gpath is None and node.name != "render_v3_pool":
            continue
        col = _FmtCollector()
        for child in node.body:
            col.visit(child)
        gpath = gpath or "/pool"
        group_info[gpath] = {
            "renderer": node.name,
            "bucket": node.name in bucket_groups,
            "line": node.lineno,
            "guarded": col.has_guarded_return,
        }
        for s in col.series:
            s["group"] = gpath
            s["file"] = METRICS_FILE
            if col.has_guarded_return or gpath == "/pool":
                s["conditional"] = True
            series.append(s)
    return series, group_info


# -- routes -----------------------------------------------------------------


def extract_s3_routes(index) -> list[dict]:
    tree = _parse(index, APP_FILE)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_route"
            and len(node.args) >= 2
        ):
            method = _const_str(node.args[0])
            path = _const_str(node.args[1])
            if method and path:
                out.append({
                    "method": method, "path": path,
                    "file": APP_FILE, "line": node.lineno,
                })
    return out


def _dispatch_terms(test: ast.AST, subject: str) -> tuple[list[str], list[str]]:
    """(values-for-subject, methods) from one dispatch If test.
    Handles ``subj == "x"``, ``subj in ("a", "b")``,
    ``subj.startswith("p")`` and And-combinations with ``m == ...``."""
    subj_vals: list[str] = []
    methods: list[str] = []

    def one(node):
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            for v in node.values:
                one(v)
            return
        if isinstance(node, ast.Compare) and len(node.comparators) == 1:
            left, cmp = node.left, node.comparators[0]
            if isinstance(left, ast.Name):
                vals = []
                s = _const_str(cmp)
                if s is not None:
                    vals = [s]
                elif isinstance(cmp, (ast.Tuple, ast.List, ast.Set)):
                    vals = [
                        v for v in (_const_str(e) for e in cmp.elts)
                        if v is not None
                    ]
                if left.id == subject:
                    subj_vals.extend(vals)
                elif left.id == "m":
                    methods.extend(vals)
            return
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "startswith"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == subject
            and node.args
        ):
            s = _const_str(node.args[0])
            if s is not None:
                subj_vals.append(s + "*")

    one(test)
    return subj_vals, methods


def _extract_dispatch(index, relpath: str, func_name: str,
                      subject: str) -> list[dict]:
    tree = _parse(index, relpath)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == func_name
        ):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.If):
                continue
            vals, methods = _dispatch_terms(sub.test, subject)
            for v in vals:
                out.append({
                    "op": v,
                    "methods": sorted(set(methods)) or ["*"],
                    "file": relpath, "line": sub.lineno,
                })
    return out


def extract_admin_routes(index) -> list[dict]:
    return _extract_dispatch(index, ADMIN_FILE, "handle_admin", "op")


def extract_sts_actions(index) -> list[dict]:
    return _extract_dispatch(index, STS_FILE, "handle_sts", "action")


# -- trace types ------------------------------------------------------------


def extract_trace_types(index) -> dict[str, dict]:
    tree = _parse(index, TRACE_FILE)
    if tree is None:
        return {}
    declared: dict[str, dict] = {}
    const_to_value: dict[str, str] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name) or not tgt.id.startswith("TYPE_"):
            continue
        v = _const_str(node.value)
        if v is not None:
            declared[v] = {
                "const": tgt.id, "line": node.lineno, "published": [],
            }
            const_to_value[tgt.id] = v
    # publish evidence: any use of the TYPE_* constant or a literal
    # `"type": "<value>"` record field, anywhere else in the package
    for relpath in sorted(index.paths):
        if relpath == TRACE_FILE or relpath.startswith("analysis/"):
            continue
        src = _read(index, relpath)
        if src is None:
            continue
        for i, line in enumerate(src.splitlines(), 1):
            for m in _TYPE_CONST_RE.finditer(line):
                value = const_to_value.get("TYPE_" + m.group(1))
                if value is not None:
                    declared[value]["published"].append(f"{relpath}:{i}")
            for m in _RECORD_TYPE_RE.finditer(line):
                if m.group(1) in declared:
                    declared[m.group(1)]["published"].append(f"{relpath}:{i}")
    return declared


# -- fault surface ----------------------------------------------------------


def extract_fault(index) -> dict:
    tree = _parse(index, FAULT_FILE)
    if tree is None:
        return {"boundaries": [], "modes": {}, "checks": []}
    boundaries: list[str] = []
    modes: dict[str, list[str]] = {}
    mode_lines: dict[str, int] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id == "BOUNDARIES" and isinstance(node.value, (ast.Tuple, ast.List)):
            boundaries = [
                v for v in (_const_str(e) for e in node.value.elts)
                if v is not None
            ]
        if tgt.id == "MODES" and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                b = _const_str(k)
                if b is None:
                    continue
                ms: list[str] = []
                for sub in ast.walk(v):
                    s = _const_str(sub)
                    if s is not None:
                        ms.append(s)
                modes[b] = sorted(set(ms))
                mode_lines[b] = k.lineno
    checks: list[dict] = []
    bset = set(boundaries)
    for relpath in sorted(index.paths):
        if relpath.startswith("analysis/"):
            continue
        src = _read(index, relpath)
        if src is None or ".check(" not in src:
            continue
        try:
            ftree = ast.parse(src, filename=relpath)
        except SyntaxError:
            continue
        for node in ast.walk(ftree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "check"
                and node.args
            ):
                continue
            boundary = _const_str(node.args[0])
            if boundary not in bset:
                continue

            def arg(i, name):
                if len(node.args) > i:
                    return node.args[i]
                for kw in node.keywords:
                    if kw.arg == name:
                        return kw.value
                return None

            tgt_node = arg(1, "target")
            op_node = arg(2, "op")
            modes_node = arg(3, "modes")
            site_modes: list[str] = []
            # only literal tuples count; a computed modes expression
            # (e.g. self._modes_for(name)) is dynamic -> [] = any mode
            if isinstance(modes_node, (ast.Tuple, ast.List, ast.Set)):
                for e in modes_node.elts:
                    s = _const_str(e)
                    if s is not None:
                        site_modes.append(s)
            checks.append({
                "boundary": boundary,
                "target": _const_str(tgt_node) or "<dynamic>"
                if tgt_node is not None else "<dynamic>",
                "op": _const_str(op_node) or "<dynamic>"
                if op_node is not None else "",
                "modes": sorted(set(site_modes)),  # [] = any mode
                "file": relpath, "line": node.lineno,
            })
    return {
        "boundaries": boundaries,
        "modes": modes,
        "mode_lines": mode_lines,
        "checks": checks,
    }


# -- error codes + knobs ----------------------------------------------------


def extract_error_codes(index) -> list[dict]:
    tree = _parse(index, S3ERR_FILE)
    if tree is None:
        return []
    out = []
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        fn = node.value.func
        if not (isinstance(fn, ast.Name) and fn.id == "APIError"):
            continue
        args = node.value.args
        if len(args) >= 3:
            code = _const_str(args[0])
            status = args[2]
            if code and isinstance(status, ast.Constant):
                out.append({
                    "code": code, "status": status.value,
                    "line": node.lineno,
                })
    return out


def extract_knobs() -> list[str]:
    from .knobs import KNOBS, PREFIX_KNOBS

    return sorted(KNOBS) + sorted(PREFIX_KNOBS)


# -- the manifest -----------------------------------------------------------


def extract(index) -> dict:
    """The whole observable surface as one JSON-serializable manifest.
    Empty when the analyzed tree has no server/ (subset runs)."""
    series, groups = extract_metrics(index)
    return {
        "metrics": series,
        "groups": groups,
        "s3_routes": extract_s3_routes(index),
        "admin_routes": extract_admin_routes(index),
        "sts_actions": extract_sts_actions(index),
        "trace_types": extract_trace_types(index),
        "fault": extract_fault(index),
        "error_codes": extract_error_codes(index),
        "knobs": extract_knobs(),
    }
