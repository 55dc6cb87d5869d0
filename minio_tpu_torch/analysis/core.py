"""miniovet core: findings, pragmas, file walking, rule registry.

A rule is a callable ``rule(tree, ctx) -> Iterable[Finding]`` registered
under a stable id. ``analyze_source`` parses once, runs every requested
rule, then drops findings suppressed by a ``# miniovet: ignore[rule]``
pragma on the finding's line. Unused pragmas are themselves reported
under ``--strict`` (rule id ``pragma``) so suppressions cannot rot.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

# anchored at the start of a COMMENT token: a docstring or a comment
# merely *mentioning* the syntax is not a suppression
PRAGMA_RE = re.compile(
    r"^#\s*miniovet:\s*ignore\[([a-z0-9_,\s-]+)\]"
)

# rule id -> callable; populated by @rule below, finalized at the bottom
# of this module by importing the rule modules (they self-register).
ALL_RULES: dict[str, Callable] = {}


def rule(rule_id: str):
    """Decorator registering ``fn(tree, ctx)`` under ``rule_id``."""

    def deco(fn):
        fn.rule_id = rule_id
        ALL_RULES[rule_id] = fn
        return fn

    return deco


@dataclass(frozen=True, order=True)
class Finding:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:  # clickable file:line: rule: message form
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


@dataclass
class FileContext:
    """Per-file state shared by every rule."""

    path: str            # path as reported in findings
    relpath: str         # package-relative posix path ("server/app.py")
    source: str
    lines: list[str] = field(default_factory=list)
    # line -> set of rule ids suppressed there ("*" suppresses all)
    pragmas: dict[int, set[str]] = field(default_factory=dict)

    # finding line -> pragma lines whose tags cover it
    _targets: dict[int, list[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.lines = self.source.splitlines()
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.source).readline)
            )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return  # analyze_source reports the parse error itself
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = PRAGMA_RE.match(tok.string)
            if not m:
                continue
            i = tok.start[0]
            self.pragmas[i] = {
                r.strip() for r in m.group(1).split(",") if r.strip()
            }
            # a pragma on a standalone comment line covers the next code
            # line (so long reasons can precede the statement); an inline
            # pragma covers its own line
            target = i
            if self.lines[i - 1].lstrip().startswith("#"):
                j = i + 1
                while j <= len(self.lines) and (
                    not self.lines[j - 1].strip()
                    or self.lines[j - 1].lstrip().startswith("#")
                ):
                    j += 1
                target = j
            self._targets.setdefault(target, []).append(i)

    def suppressed(self, line: int, rule_id: str) -> int | None:
        """Pragma line covering (line, rule_id), or None."""
        for pline in self._targets.get(line, ()):
            tags = self.pragmas[pline]
            if rule_id in tags or "*" in tags:
                return pline
        return None


def _package_relpath(path: str) -> str:
    """Path relative to the minio_tpu_torch package root, posix-style, so rules
    can scope themselves ("parallel/dispatcher.py"). Falls back to the
    basename for files outside the package (fixtures, tests)."""
    norm = path.replace(os.sep, "/")
    marker = "minio_tpu_torch/"
    idx = norm.rfind(marker)
    if idx >= 0:
        return norm[idx + len(marker):]
    return norm.rsplit("/", 1)[-1]


def analyze_tree(
    tree: ast.AST,
    ctx: FileContext,
    rules: Iterable[str] | None = None,
) -> tuple[list[Finding], set[int]]:
    """Run the requested per-file rules over a pre-parsed tree. Returns
    (findings after pragma suppression, pragma lines that suppressed
    something) — the caller decides what to do about unused pragmas
    (interprocedural passes may still consume them)."""
    from .project import INTERPROC_PASSES  # deferred: project imports core

    findings: list[Finding] = []
    used_pragma_lines: set[int] = set()
    wanted = set(rules) if rules is not None else set(ALL_RULES)
    unknown = wanted - set(ALL_RULES) - set(INTERPROC_PASSES) - {"pragma"}
    if unknown:
        # a typo'd rule id must not come back as a clean result
        raise KeyError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
    for rule_id in sorted(wanted):
        if rule_id == "pragma" or rule_id not in ALL_RULES:
            continue  # pseudo-rule / interprocedural pass id
        fn = ALL_RULES[rule_id]
        for f in fn(tree, ctx):
            pline = ctx.suppressed(f.line, f.rule)
            if pline is not None:
                used_pragma_lines.add(pline)
            else:
                findings.append(f)
    return findings, used_pragma_lines


def unused_pragma_findings(
    path: str,
    pragmas: dict[int, set[str]],
    used_pragma_lines: set[int],
) -> list[Finding]:
    """`pragma` pseudo-rule: unused suppressions rot into lies about the
    code, so every pragma must have suppressed at least one finding."""
    out = []
    for line, tags in sorted(pragmas.items()):
        if line not in used_pragma_lines:
            out.append(
                Finding(
                    path, line, "pragma",
                    "unused `miniovet: ignore[%s]` pragma (nothing "
                    "suppressed on this line)" % ",".join(sorted(tags)),
                )
            )
    return out


def analyze_source(
    source: str,
    path: str = "<string>",
    rules: Iterable[str] | None = None,
    relpath: str | None = None,
) -> list[Finding]:
    """Run the requested rules (default: all) over one source blob."""
    ctx = FileContext(
        path=path,
        relpath=relpath if relpath is not None else _package_relpath(path),
        source=source,
    )
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(path, e.lineno or 1, "parse", f"syntax error: {e.msg}")
        ]
    findings, used_pragma_lines = analyze_tree(tree, ctx, rules)
    # only meaningful on full runs — a --select subset can't tell an
    # unused pragma from one whose rule didn't run
    if rules is None:
        findings.extend(
            unused_pragma_findings(path, ctx.pragmas, used_pragma_lines)
        )
    return sorted(findings)


def analyze_file(
    path: str, rules: Iterable[str] | None = None
) -> list[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return analyze_source(fh.read(), path=path, rules=rules)


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    # native sources ride the same walk: the knob-native rule scans them
    # (rules_native.py); everything else only sees .py files
    from .rules_native import NATIVE_EXTS

    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "fixtures")
                )
                for name in sorted(files):
                    if name.endswith(".py") or name.endswith(NATIVE_EXTS):
                        yield os.path.join(root, name)


def analyze_paths(
    paths: Iterable[str],
    rules: Iterable[str] | None = None,
    jobs: int = 1,
    cache_path: str | None = None,
) -> list[Finding]:
    """Whole-program analysis: per-file rules plus the interprocedural
    passes (call-graph reachability, lock ordering, coherence paths) over
    everything reachable from `paths` as one program. See project.py."""
    from .project import analyze_project

    return analyze_project(
        paths, rules=rules, jobs=jobs, cache_path=cache_path
    ).findings


# -- shared AST helpers used by several rule modules -----------------------


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_nodes_outside_nested_functions(
    body: Iterable[ast.stmt],
) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class
    definitions — 'is this await inside THIS function' questions."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def contains_await(body: Iterable[ast.stmt]) -> bool:
    return any(
        isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
        for n in iter_nodes_outside_nested_functions(body)
    )


class FunctionStackVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the enclosing function stack; rules subclass
    this to know whether a node sits in async or sync code."""

    def __init__(self) -> None:
        self.stack: list[ast.AST] = []

    @property
    def in_async(self) -> bool:
        for fn in reversed(self.stack):
            if isinstance(fn, ast.AsyncFunctionDef):
                return True
            if isinstance(fn, ast.FunctionDef):
                return False
        return False

    @property
    def current_function(self) -> ast.AST | None:
        for fn in reversed(self.stack):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return fn
        return None

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()


# Importing the rule modules registers them in ALL_RULES. Keep at the
# bottom: they import helpers from this module.
from . import rules_async   # noqa: E402,F401
from . import rules_tpu     # noqa: E402,F401
from . import rules_locks   # noqa: E402,F401
from . import rules_knobs   # noqa: E402,F401
from . import rules_obs     # noqa: E402,F401
from . import rules_retry   # noqa: E402,F401
from . import rules_cache   # noqa: E402,F401
from . import rules_native  # noqa: E402,F401
from . import rules_copy    # noqa: E402,F401
