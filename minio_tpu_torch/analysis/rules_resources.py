"""``resources`` — interprocedural resource-leak pass.

The reference binary leans on Go's ``defer`` for every lock, drive
handle, and temp file; this pass is the Python port's machine-checked
equivalent. The per-file summaries (project.py) record every resource
**acquisition site** by kind:

- ``nslock``   — namespace lock handles (the ``_lock_dyn``/``mtx.lock``
  idiom); a stranded one blocks writers until TTL expiry;
- ``spool``    — temp files/dirs (``tempfile.mkstemp`` & friends):
  multipart staging, NVMe cache spill;
- ``future``   — executor futures bound to a name (``f = pool.submit``):
  a dropped future is a silently lost exception;
- ``task``     — asyncio tasks bound to a name: an unanchored task can
  be garbage-collected mid-flight;
- ``file``     — raw file handles assigned outside a ``with``;
- ``span``     — obs trace spans (context-manager balanced by the
  per-file ``span`` rule; recorded for the ownership table).

Each acquisition is then proved to satisfy **ownership semantics** on
every non-exception exit of the acquiring function (the same
per-return-path definite-call machinery the coherence pass uses —
branch joins intersect, ``finally`` blocks credit every exit through
them):

- **balanced**    — acquired via context manager, released by scope;
- **released**    — a release-shaped call on the bound name
  (``mtx.runlock()``, ``os.close(fd)``, ``fut.result()``, ``await t``)
  definitely executes before the exit;
- **transferred** — the handle is returned to the caller (who now owns
  it), or passed to a callee that takes ownership — stores it on
  ``self``, releases it, or returns it onward — resolved
  interprocedurally through the call graph (``ObjectHandle(...,
  mutex=mtx)`` is the canonical shape: ``__init__`` stores the lock,
  ``close()`` releases it);
- **escapes**     — stored on ``self`` or into a container: the owner's
  lifetime, not this call's.

An exit none of these cover is a **leak finding**. Exception exits are
exempt (the error propagates; cleanup there is the per-file
lock-discipline rule's job). Acquisitions inside loops, branches, or
cleanup blocks get the path-insensitive version of the proof (any
release/transfer/escape of the name counts) — the exit machinery cannot
see into loop bodies, and a conditional acquisition has no single
"after" path.

The proven ownership of every acquisition is generated into
``minio_tpu_torch/docs/RESOURCES.md`` (``--gen-resources``, ``make docs``, tier-1 sync
gate) — the table the runtime **leak witness**
(analysis/sanitizer.py, ``MINIO_TPU_SANITIZE=1``) cross-validates:
acquisition wrappers register weakref finalizers, and a resource
collected unreleased emits a ``resource.leak`` obs record with its
acquisition stack.

Suppression: ``# miniovet: ignore[resources] -- reason`` on the
acquisition line.
"""

from __future__ import annotations

from .core import Finding
from .project import (
    FREE_RELEASERS,
    ProjectIndex,
    RESOURCE_RELEASES,
    WAITER_CALLS,
)

RULE_ID = "resources"

_MAX_TRANSFER_DEPTH = 4


class ResourcesEngine:
    def __init__(self, index: ProjectIndex, suppressed):
        self.ix = index
        self.suppressed = suppressed
        self._accepts: dict[tuple[str, str], bool] = {}
        self._resolved: dict[tuple[str, str], list[str]] = {}

    # ---- shared helpers ----

    def _resolve(self, key: str, expr: str) -> list[str]:
        memo = self._resolved.get((key, expr))
        if memo is None:
            relpath = self.ix.func_file[key]
            qual = key.split("::", 1)[1]
            memo = self.ix.resolve_call(relpath, qual, expr)
            self._resolved[(key, expr)] = memo
        return memo

    # ---- ownership transfer through the call graph ----

    def _accepts_ownership(self, key: str, param: str,
                           depth: int = 0) -> bool:
        """Does function `key` take ownership of the argument bound to
        `param`? Yes when the callee stores it (escapes), releases it,
        returns it onward, or hands it to another accepting callee.
        Only positive results are memoized: a False computed under the
        recursion depth budget must not poison a later, shallower query
        (the answer would become analysis-order-dependent)."""
        memo = self._accepts.get((key, param))
        if memo is not None:
            return memo
        self._accepts[(key, param)] = False  # cycle guard
        try:
            result = self._accepts_compute(key, param, depth)
        finally:
            del self._accepts[(key, param)]
        if result:
            self._accepts[(key, param)] = True
        return result

    def _accepts_compute(self, key: str, param: str, depth: int) -> bool:
        fs = self.ix.functions.get(key)
        if fs is None:
            return False
        if param in fs.get("escapes", ()):
            return True
        for e in fs.get("releases", ()):
            if e["var"] == param:
                return True
        for ex in fs.get("exits", ()):
            if param in ex.get("names", ()):
                return True
        if depth < _MAX_TRANSFER_DEPTH:
            for c in fs.get("calls", ()):
                pos = [i for i, a in enumerate(c.get("argv", ()))
                       if a == param]
                kws = [k for k, v in c.get("kw", {}).items() if v == param]
                if not pos and not kws:
                    continue
                for tgt in self._resolve(key, c["expr"]):
                    for p in self._callee_params(tgt, c, param):
                        if self._accepts_ownership(tgt, p, depth + 1):
                            return True
        return False

    def _callee_params(self, tgt: str, call: dict,
                       var: str) -> list[str]:
        """Parameter names of `tgt` that the argument `var` binds to in
        this call record (positional by index, keyword by name)."""
        fs = self.ix.functions.get(tgt)
        if fs is None:
            return []
        params = list(fs.get("params", ()))
        if fs.get("class") and params and params[0] in ("self", "cls"):
            params = params[1:]
        out = []
        for i, a in enumerate(call.get("argv", ())):
            if a == var and i < len(params):
                out.append(params[i])
        for k, v in call.get("kw", {}).items():
            if v == var and k in params:
                out.append(k)
        return out

    # ---- per-acquisition proof ----

    def _release_events(self, fs: dict, kind: str, var: str) -> list[dict]:
        attrs = RESOURCE_RELEASES.get(kind, ())
        out = []
        for e in fs.get("releases", ()):
            if e["var"] != var:
                continue
            how = e["how"]
            if how == "await" or how in attrs \
                    or how in FREE_RELEASERS or how in WAITER_CALLS \
                    or how.split(".")[-1] in ("as_completed",):
                out.append(e)
        return out

    def _transfer_calls(self, key: str, fs: dict, var: str) -> list[dict]:
        """Call records that pass `var` to an ownership-accepting callee."""
        out = []
        for c in fs.get("calls", ()):
            if var not in c.get("argv", ()) \
                    and var not in c.get("kw", {}).values():
                continue
            for tgt in self._resolve(key, c["expr"]):
                if any(
                    self._accepts_ownership(tgt, p)
                    for p in self._callee_params(tgt, c, var)
                ):
                    out.append(c)
                    break
        return out

    def analyze(self) -> tuple[list[Finding], list[dict]]:
        findings: list[Finding] = []
        table: list[dict] = []
        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            resources = fs.get("resources") or ()
            if not resources:
                continue
            relpath = self.ix.func_file[key]
            for r in resources:
                if self.suppressed(relpath, r["line"], RULE_ID):
                    continue
                row = {
                    "kind": r["kind"],
                    "file": relpath,
                    "line": r["line"],
                    "function": fs["name"],
                    "expr": r["expr"],
                }
                if r["cm"]:
                    row["ownership"] = "balanced"
                    table.append(row)
                    continue
                var = r.get("var")
                if r.get("escaped") or (var and var in fs.get("escapes", ())):
                    row["ownership"] = "escapes"
                    table.append(row)
                    continue
                if var is None:
                    # unbound acquisition result: fire-and-forget
                    # (`pool.submit(ev.set)`) — deliberate, table-only
                    row["ownership"] = "dropped"
                    table.append(row)
                    continue
                rel = self._release_events(fs, r["kind"], var)
                xfer = self._transfer_calls(key, fs, var)
                exits = [
                    ex for ex in fs.get("exits", ())
                    if ex["line"] >= r["line"]
                ]
                returned = any(
                    var in ex.get("names", ()) for ex in exits
                )
                if r.get("loose"):
                    # loop/branch/cleanup acquisition: exits can't see
                    # the acquiring path — any release/transfer/return
                    # of the name in the function counts
                    if rel or xfer or returned:
                        row["ownership"] = (
                            "released" if rel else "transferred"
                        )
                        table.append(row)
                        continue
                    findings.append(self._finding(relpath, r, fs, None))
                    continue
                bad_exits = []
                proofs: set[str] = set()
                # `await t` rides async control flow the exit machinery
                # can't anchor — credit globally
                awaited = any(e["how"] == "await" for e in rel)
                for ex in exits:
                    if var in ex.get("names", ()):
                        proofs.add("transferred")
                        continue
                    before = set(ex.get("before", ()))
                    if ex.get("tail"):
                        before.add(ex["tail"])
                    # a release in a finally covers every exit of its
                    # try — exits at/after the try's first line (an
                    # earlier return above the try is NOT covered)
                    fin_ok = any(
                        e.get("fin") and ex["line"] >= e["fin"]
                        for e in rel
                    )
                    if any(
                        f"{var}.{e['how']}" in before or e["how"] in before
                        for e in rel
                    ) or awaited or fin_ok:
                        proofs.add("released")
                        continue
                    if any(c["expr"] in before for c in xfer):
                        proofs.add("transferred")
                        continue
                    bad_exits.append(ex["line"])
                if bad_exits:
                    findings.append(
                        self._finding(relpath, r, fs, bad_exits)
                    )
                else:
                    row["ownership"] = "+".join(sorted(proofs)) \
                        if proofs else "no-exit"
                    table.append(row)
        findings.sort()
        table.sort(key=lambda r: (r["kind"], r["file"], r["line"]))
        return findings, table

    def _finding(self, relpath: str, r: dict, fs: dict,
                 bad_exits: list[int] | None) -> Finding:
        attrs = ", ".join(
            f"`.{a}()`" for a in RESOURCE_RELEASES.get(r["kind"], ())
        )
        var = r.get("var") or "<anonymous>"
        where = (
            f"exit(s) at line {', '.join(str(x) for x in bad_exits)}"
            if bad_exits else "some path"
        )
        return Finding(
            relpath, r["line"], RULE_ID,
            f"{r['kind']} `{var}` acquired here (`{r['expr']}`) in "
            f"`{fs['name']}` can reach {where} without being released "
            f"({attrs}), returned, or transferred to an owner; release "
            "it in a finally block or hand it to an owning object "
            "(minio_tpu_torch/docs/RESOURCES.md)",
        )


def run(index: ProjectIndex, suppressed) -> tuple[list[Finding], list[dict]]:
    return ResourcesEngine(index, suppressed).analyze()


def generate_resources_md(table: list[dict]) -> str:
    """minio_tpu_torch/docs/RESOURCES.md content: the proven ownership of every resource
    acquisition in the tree. The runtime leak witness
    (analysis/sanitizer.py) cross-validates the rows at runtime: a
    resource collected unreleased emits a ``resource.leak`` record."""
    out = [
        "# Resource ownership map",
        "",
        "Generated from the `resources` interprocedural pass by",
        "`python -m minio_tpu_torch.analysis --gen-resources` — do not edit by",
        "hand. Every non-context-manager resource acquisition in the",
        "tree is listed with the ownership the pass proved on every",
        "non-exception exit of the acquiring function: `released` (a",
        "release call definitely executes), `transferred` (returned or",
        "handed to an owning object, resolved through the call graph),",
        "`escapes` (stored on `self`/a container — the owner's",
        "lifetime), `dropped` (result deliberately unbound:",
        "fire-and-forget). Context-manager acquisitions are balanced by",
        "construction and summarized below. At runtime,",
        "`MINIO_TPU_SANITIZE=1` arms a leak witness whose weakref",
        "finalizers report any tracked resource collected unreleased as",
        "a `resource.leak` obs record.",
        "",
        "## Ownership table",
        "",
        "| Kind | Acquired in | Site | Via | Ownership |",
        "|---|---|---|---|---|",
    ]
    balanced: dict[str, int] = {}
    for row in table:
        if row["ownership"] == "balanced":
            balanced[row["kind"]] = balanced.get(row["kind"], 0) + 1
            continue
        out.append(
            f"| {row['kind']} | `{row['function']}` "
            f"| {row['file']}:{row['line']} | `{row['expr']}` "
            f"| {row['ownership']} |"
        )
    out += [
        "",
        "## Context-manager balanced (by construction)",
        "",
        "| Kind | Acquisition sites |",
        "|---|---|",
    ]
    for kind in sorted(balanced):
        out.append(f"| {kind} | {balanced[kind]} |")
    out.append("")
    return "\n".join(out)
