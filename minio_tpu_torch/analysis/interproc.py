"""Interprocedural passes over the project call graph.

This module implements four whole-program properties the per-file rules
cannot see (the ``races``, ``resources``, ``error-taint``, and
``dead-knob`` passes live in their own modules — rules_races.py,
rules_resources.py, rules_errors.py, rules_knobs.py — and are driven
from ``run_passes`` here):

- ``blocking-reachable``      a blocking primitive (``time.sleep``, sync
  socket/DNS, ``subprocess.run``, ``requests.*``, ``Future.result()``)
  reachable from an ``async def`` through any chain of *sync* helpers
  stalls the event loop exactly like a direct call. Executor/thread
  submission boundaries (``asyncio.to_thread``, ``run_in_executor``,
  ``pool.submit``, ``threading.Thread``) sever the chain; loop-callback
  scheduling (``call_soon``/``call_later``) does not.
- ``lock-order``              the global lock-acquisition graph (edge
  ``A -> B`` when B is acquired — directly or through callees — while A
  is held) must be acyclic; the topological order is the canonical
  lock ordering (minio_tpu_torch/docs/LOCK_ORDER.md, checked at runtime by the
  sanitizer's lock witness).
- ``coherence-path``          every mutation entry point in ``erasure/``
  must reach the ``SetCache.invalidate_*`` choke point on every
  non-exception exit; a return path that skips invalidation is a stale
  serve on some other node.
- ``cancellation-reachable``  a broad ``except`` in async code around a
  *sync* callee that waits on a future (``.result()``) swallows
  ``CancelledError`` raised through that wait just like one around an
  ``await`` — the per-file rule only sees lexical awaits.

Findings anchor where the bad edge enters (the call site / the return /
the handler) and print the full chain so the fix target is obvious.
Suppression: ``# miniovet: ignore[<pass>]`` on the anchored line; a
pragma on a blocking *primitive's* line additionally declassifies it as
a source for every chain (one pragma at ``Backoff.sleep`` instead of
one per caller).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .core import Finding
from .project import ProjectIndex

# mutation entry points for the coherence pass: public erasure-layer
# methods that commit object/bucket state and therefore must invalidate
MUTATOR_RE = re.compile(
    r"^(put_object|delete_object|delete_objects|copy_object"
    r"|complete_multipart_upload|update_object_metadata|transition_object"
    r"|restore_object|set_object_tags|delete_object_tags|heal_object"
    r"|delete_bucket)$"
)

_INVALIDATE_METHODS = ("invalidate_object", "invalidate_prefix",
                       "invalidate_bucket", "bump_epoch", "clear")

_MAX_CANDIDATES = 4  # loose resolution cap for ?.method receivers


@dataclass
class IPResult:
    findings: list[Finding] = field(default_factory=list)
    lock_order: list[str] = field(default_factory=list)
    lock_edges: dict[str, list[str]] = field(default_factory=dict)
    guard_table: list[dict] = field(default_factory=list)
    resource_table: list[dict] = field(default_factory=list)
    # observable-surface record from the `surface` pass:
    # {"manifest": ..., "parity": ...} (empty on subset runs)
    surface: dict = field(default_factory=dict)


def run_passes(index: ProjectIndex, passes, suppressed=None,
               native_knob_reads=frozenset()) -> IPResult:
    """`suppressed(relpath, line, tag) -> bool` declassifies sources.
    `native_knob_reads` feeds the dead-knob pass with getenv evidence
    from native sources (they have no summaries)."""
    if suppressed is None:
        suppressed = lambda relpath, line, tag: False  # noqa: E731
    res = IPResult()
    eng = _Engine(index, suppressed)
    if "blocking-reachable" in passes:
        res.findings.extend(eng.blocking_reachable())
    if "lock-order" in passes:
        findings, order, edges = eng.lock_order()
        res.findings.extend(findings)
        res.lock_order = order
        res.lock_edges = edges
    if "coherence-path" in passes:
        res.findings.extend(eng.coherence_path())
    if "cancellation-reachable" in passes:
        res.findings.extend(eng.cancellation_reachable())
    shared_contexts: dict | None = None
    if "races" in passes:
        from . import rules_races

        races_eng = rules_races.RacesEngine(index, suppressed)
        findings, table = rules_races.run(index, suppressed,
                                          engine=races_eng)
        res.findings.extend(findings)
        res.guard_table = table
        # the error-taint pass reuses this execution-context fixpoint
        # instead of recomputing the whole-program map
        shared_contexts = races_eng.contexts
    if "resources" in passes:
        from . import rules_resources

        findings, table = rules_resources.run(index, suppressed)
        res.findings.extend(findings)
        res.resource_table = table
    if "error-taint" in passes:
        from . import rules_errors

        res.findings.extend(
            rules_errors.run(index, suppressed,
                             contexts=shared_contexts)
        )
    if "dead-knob" in passes:
        from .rules_knobs import dead_knob_findings

        res.findings.extend(
            dead_knob_findings(index, native_knob_reads, suppressed)
        )
    if "surface" in passes:
        from . import rules_surface

        findings, record = rules_surface.run(index, suppressed)
        res.findings.extend(findings)
        res.surface = record
    res.findings.sort()
    return res


class _Engine:
    def __init__(self, index: ProjectIndex, suppressed):
        self.ix = index
        self.suppressed = suppressed
        self._blocked: dict[str, list | None] = {}
        self._waity: dict[str, list | None] = {}
        self._acq: dict[str, dict[str, tuple[str, int]] | None] = {}
        self._inval: dict[str, bool | None] = {}

    # ---- shared helpers ----

    def _resolve(self, key: str, expr: str) -> list[str]:
        relpath = self.ix.func_file[key]
        qual = key.split("::", 1)[1]
        return self.ix.resolve_call(relpath, qual, expr)

    def _fn_loc(self, key: str, line: int | None = None) -> tuple[str, int]:
        fs = self.ix.functions[key]
        return self.ix.func_file[key], line if line is not None else fs["line"]

    # ---- blocking-reachable ----

    def _blocked_chain(self, key: str) -> list | None:
        """For a SYNC function: chain [(desc, relpath, line), ...] down to
        a blocking primitive reachable through plain calls, else None."""
        if key in self._blocked:
            return self._blocked[key]
        self._blocked[key] = None  # cycle guard: in-progress = not blocked
        fs = self.ix.functions[key]
        if fs["async"]:
            return None
        relpath = self.ix.func_file[key]
        for p in fs["prims"]:
            # only an explicit `ignore[blocking-reachable]` declassifies a
            # primitive as a chain source — an `ignore[blocking]` says
            # "this sleep is daemon-thread pacing", which is exactly the
            # claim a chain from an async def would disprove
            if self.suppressed(relpath, p["line"], "blocking-reachable"):
                continue
            chain = [(f"`{p['what']}`", relpath, p["line"])]
            self._blocked[key] = chain
            return chain
        for w in fs["waits"]:
            if self.suppressed(relpath, w["line"], "blocking-reachable"):
                continue
            chain = [(f"`{w['expr']}()` (future wait)", relpath, w["line"])]
            self._blocked[key] = chain
            return chain
        for c in fs["calls"]:
            if c["kind"] != "call":
                continue  # executor/thread/task edges leave this thread
            for tgt in self._resolve(key, c["expr"]):
                if self.ix.functions.get(tgt, {}).get("async"):
                    continue  # a sync frame can't run an async callee
                sub = self._blocked_chain(tgt)
                if sub is not None:
                    chain = [(f"`{c['expr']}`", relpath, c["line"])] + sub
                    self._blocked[key] = chain
                    return chain
        return None

    def blocking_reachable(self) -> list[Finding]:
        findings = []
        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            if not fs["async"]:
                continue
            relpath = self.ix.func_file[key]
            seen_lines: set[tuple[int, str]] = set()
            for c in fs["calls"]:
                if c["kind"] not in ("call", "task"):
                    continue
                for tgt in self._resolve(key, c["expr"]):
                    if self.ix.functions.get(tgt, {}).get("async"):
                        continue
                    chain = self._blocked_chain(tgt)
                    if chain is None:
                        continue
                    if (c["line"], c["expr"]) in seen_lines:
                        continue
                    seen_lines.add((c["line"], c["expr"]))
                    hops = " -> ".join(
                        f"{d} ({rp}:{ln})" for d, rp, ln in chain
                    )
                    findings.append(Finding(
                        relpath, c["line"], "blocking-reachable",
                        f"async `{fs['name']}` reaches a blocking call "
                        f"through sync helper(s): `{c['expr']}` -> {hops}; "
                        "run the chain on an executor or make it async",
                    ))
        return findings

    # ---- lock-order ----

    def _acquired_trans(self, key: str, depth: int = 0
                        ) -> dict[str, tuple[str, int]]:
        """All canonical locks this function may acquire (itself or via
        sync callees): lock -> example (relpath, line) site."""
        memo = self._acq.get(key)
        if memo is not None:
            return memo
        self._acq[key] = {}  # cycle guard
        out: dict[str, tuple[str, int]] = {}
        fs = self.ix.functions[key]
        relpath = self.ix.func_file[key]
        qual = key.split("::", 1)[1]
        for a in fs.get("acquires", ()):
            canon = self.ix.canon_lock(relpath, qual, a["lock"])
            out.setdefault(canon, (relpath, a["line"]))
        if depth < 12:
            for c in fs["calls"]:
                if c["kind"] not in ("call", "await"):
                    continue  # awaited callees run on this task: locks count
                for tgt in self._resolve(key, c["expr"]):
                    for lk, site in self._acquired_trans(tgt, depth + 1).items():
                        out.setdefault(lk, (relpath, c["line"]))
        self._acq[key] = out
        return out

    def lock_order(self) -> tuple[list[Finding], list[str], dict]:
        # edge (A -> B): B acquired while A held; value = example site
        edges: dict[tuple[str, str], tuple[str, int]] = {}
        locks_seen: set[str] = set()
        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            relpath = self.ix.func_file[key]
            qual = key.split("::", 1)[1]
            for h in fs.get("holds", ()):
                outer = self.ix.canon_lock(relpath, qual, h["lock"])
                locks_seen.add(outer)
                inner: dict[str, tuple[str, int]] = {}
                for a in h.get("acquires", ()):
                    canon = self.ix.canon_lock(relpath, qual, a)
                    inner.setdefault(canon, (relpath, h["line"]))
                for cexpr in h.get("calls", ()):
                    for tgt in self._resolve(key, cexpr):
                        for lk, site in self._acquired_trans(tgt).items():
                            inner.setdefault(lk, (relpath, h["line"]))
                for lk, site in inner.items():
                    if lk == outer:
                        continue  # same class: per-instance, rank-equal
                    locks_seen.add(lk)
                    edges.setdefault((outer, lk), site)

        adj: dict[str, list[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
        for a in adj:
            adj[a] = sorted(set(adj[a]))

        findings = []
        for cycle in _find_cycles(adj):
            # the SCC members come back sorted, which is NOT an edge
            # path — anchor and report on the actual intra-SCC edges so
            # the finding (and any suppressing pragma) lands on a line
            # that participates in the cycle, deterministically
            members = set(cycle)
            intra = sorted(
                (x, y) for (x, y) in edges
                if x in members and y in members
            )
            site = edges[intra[0]]
            path = " <-> ".join(cycle)
            sites = "; ".join(
                f"{x}->{y} at {edges[(x, y)][0]}:{edges[(x, y)][1]}"
                for x, y in intra
            )
            findings.append(Finding(
                site[0], site[1], "lock-order",
                f"lock-order cycle among {path} (acquire sites: {sites}); "
                "two threads taking these locks in opposite orders "
                "deadlock — pick one order and refactor the other side",
            ))

        order = _topo_order(locks_seen, adj)
        return findings, order, {
            a: adj.get(a, []) for a in sorted(locks_seen)
        }

    # ---- coherence-path ----

    def _is_direct_invalidate(self, expr: str) -> bool:
        parts = expr.split(".")
        for i, seg in enumerate(parts[:-1]):
            if seg == "cache" and parts[i + 1] in _INVALIDATE_METHODS:
                return True
        # inside cache/ modules the choke point calls its own helpers
        return False

    def _reaches_invalidate(self, key: str, depth: int = 0) -> bool:
        memo = self._inval.get(key)
        if memo is not None:
            return memo
        self._inval[key] = False  # cycle guard
        fs = self.ix.functions.get(key)
        if fs is None:
            return False
        mod = key.split("::")[0]
        if mod.startswith("cache") and any(
            fs["name"].endswith("." + m) or fs["name"] == m
            for m in _INVALIDATE_METHODS
        ):
            self._inval[key] = True
            return True
        for c in fs["calls"]:
            if self._is_direct_invalidate(c["expr"]):
                self._inval[key] = True
                return True
        if depth < 12:
            for c in fs["calls"]:
                if c["kind"] != "call":
                    continue
                for tgt in self._resolve_loose(key, c["expr"]):
                    if self._reaches_invalidate(tgt, depth + 1):
                        self._inval[key] = True
                        return True
        return False

    def _resolve_loose(self, key: str, expr: str) -> list[str]:
        """Resolution for the ALL-paths coherence property: when the
        receiver is opaque (``pool.put_object``, ``?.put_object`` through
        a hashed-set hop), any same-named method defined in the erasure
        subsystem counts — optimistic on purpose, the property is 'some
        path invalidates' and the delegation targets all live there."""
        hits = self._resolve(key, expr)
        if hits:
            return hits
        name = expr.split(".")[-1]
        cands = [
            k for k in self.ix.method_defs.get(name, [])
            if self.ix.func_file[k].startswith("erasure/")
            and ".<locals>." not in k
        ]
        if 1 <= len(cands) <= _MAX_CANDIDATES:
            return cands
        return []

    def _expr_reaches_invalidate(self, key: str, expr: str) -> bool:
        if self._is_direct_invalidate(expr):
            return True
        return any(
            self._reaches_invalidate(tgt)
            for tgt in self._resolve_loose(key, expr)
        )

    def coherence_path(self) -> list[Finding]:
        findings = []
        for key in sorted(self.ix.functions):
            relpath = self.ix.func_file[key]
            if not relpath.startswith("erasure/"):
                continue
            fs = self.ix.functions[key]
            qual = fs["name"]
            if "." not in qual or ".<locals>." in qual:
                continue  # entry points are public class methods
            cls, meth = qual.rsplit(".", 1)
            if not MUTATOR_RE.match(meth) or cls.startswith("_"):
                continue
            exits = fs.get("exits", ())
            if not exits:
                continue
            for ex in exits:
                ok = False
                if ex["tail"] and self._expr_reaches_invalidate(key, ex["tail"]):
                    ok = True
                else:
                    for cexpr in ex["before"]:
                        if self._expr_reaches_invalidate(key, cexpr):
                            ok = True
                            break
                if not ok:
                    findings.append(Finding(
                        relpath, ex["line"], "coherence-path",
                        f"mutation entry point `{qual}` can exit here "
                        "without reaching SetCache.invalidate_* — a peer "
                        "node keeps serving the stale cached version; "
                        "route the exit through the choke point "
                        "(docs/CACHING.md)",
                    ))
        return findings

    # ---- cancellation-reachable ----

    def _wait_chain(self, key: str, depth: int = 0) -> list | None:
        """Sync-call chain from `key` down to a `.result()` future wait."""
        if key in self._waity:
            return self._waity[key]
        self._waity[key] = None
        fs = self.ix.functions.get(key)
        if fs is None or fs["async"]:
            return None
        relpath = self.ix.func_file[key]
        for w in fs["waits"]:
            if self.suppressed(relpath, w["line"], "cancellation-reachable"):
                continue
            chain = [(f"`{w['expr']}()`", relpath, w["line"])]
            self._waity[key] = chain
            return chain
        if depth < 12:
            for c in fs["calls"]:
                if c["kind"] != "call":
                    continue
                for tgt in self._resolve(key, c["expr"]):
                    sub = self._wait_chain(tgt, depth + 1)
                    if sub is not None:
                        chain = [(f"`{c['expr']}`", relpath, c["line"])] + sub
                        self._waity[key] = chain
                        return chain
        return None

    def cancellation_reachable(self) -> list[Finding]:
        findings = []
        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            if not fs["async"]:
                continue
            relpath = self.ix.func_file[key]
            for bt in fs.get("broad_trys", ()):
                chain = None
                for cexpr in bt["calls"]:
                    for tgt in self._resolve(key, cexpr):
                        if self.ix.functions.get(tgt, {}).get("async"):
                            continue
                        sub = self._wait_chain(tgt)
                        if sub is not None:
                            chain = [(f"`{cexpr}`", relpath, bt["line"])] + sub
                            break
                    if chain:
                        break
                if chain:
                    hops = " -> ".join(
                        f"{d} ({rp}:{ln})" for d, rp, ln in chain
                    )
                    findings.append(Finding(
                        relpath, bt["line"], "cancellation-reachable",
                        "broad except around a sync callee that waits on a "
                        f"future can swallow CancelledError: {hops}; add "
                        "`except asyncio.CancelledError: raise` before it "
                        "or narrow the handler",
                    ))
        return findings


# ---- graph utilities ----


def _find_cycles(adj: dict[str, list[str]]) -> list[list[str]]:
    """Elementary cycles via SCC condensation (one finding per SCC —
    enough to fail the gate and name the participants)."""
    index_counter = [0]
    stack: list[str] = []
    lowlink: dict[str, int] = {}
    number: dict[str, int] = {}
    on_stack: set[str] = set()
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                number[node] = lowlink[node] = index_counter[0]
                index_counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = adj.get(node, [])
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in number:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    lowlink[node] = min(lowlink[node], number[w])
            if recurse:
                continue
            if lowlink[node] == number[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])

    for v in sorted(adj):
        if v not in number:
            strongconnect(v)
    return sccs


def _topo_order(nodes: set[str], adj: dict[str, list[str]]) -> list[str]:
    """Deterministic topological order (lexicographic Kahn). Nodes inside
    a cycle are appended at the end, sorted — the findings already fail
    the gate; the doc stays generatable."""
    indeg: dict[str, int] = {n: 0 for n in nodes}
    for a, outs in adj.items():
        for b in outs:
            if b in indeg:
                indeg[b] += 1
    import heapq

    ready = [n for n, d in sorted(indeg.items()) if d == 0]
    heapq.heapify(ready)
    out: list[str] = []
    while ready:
        n = heapq.heappop(ready)
        out.append(n)
        for b in adj.get(n, []):
            if b in indeg:
                indeg[b] -= 1
                if indeg[b] == 0:
                    heapq.heappush(ready, b)
    leftover = sorted(n for n in nodes if n not in out)
    return out + leftover


def generate_lock_order_md(order: list[str], edges: dict[str, list[str]]) -> str:
    """minio_tpu_torch/docs/LOCK_ORDER.md content: the canonical acquisition ordering the
    static pass proved cycle-free; the runtime lock witness
    (analysis/sanitizer.py) asserts real acquisitions agree with it."""
    out = [
        "# Canonical lock ordering",
        "",
        "Generated from the `lock-order` interprocedural pass by",
        "`python -m minio_tpu_torch.analysis --gen-lock-order` — do not edit by",
        "hand. An edge `A -> B` means somewhere in the program lock B is",
        "acquired (possibly through callees) while A is held; the pass",
        "fails the build if the edge graph has a cycle, and this table is",
        "the topological order that proves it doesn't. Locks must be",
        "acquired in table order (lower rank first). At runtime,",
        "`MINIO_TPU_SANITIZE=1` installs a lock witness that reports any",
        "acquisition disagreeing with this order.",
        "",
        "| Rank | Lock | May be held while acquiring |",
        "|---|---|---|",
    ]
    for i, lk in enumerate(order):
        outs = ", ".join(f"`{x}`" for x in edges.get(lk, [])) or "_(leaf)_"
        out.append(f"| {i} | `{lk}` | {outs} |")
    out.append("")
    return "\n".join(out)
