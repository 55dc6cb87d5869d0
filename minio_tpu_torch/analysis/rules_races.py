"""``races`` — guarded-by inference + cross-context data-race pass.

The reference MinIO keeps its goroutine-heavy data plane honest with
``make test-race``; this pass is the static analogue for our
asyncio + executor-pool + daemon-thread rebuild, RacerD-style: evidence
over proof, report-with-chains, driven to zero unexplained findings.

Three stages over the project summaries (project.py):

1. **Execution-context inference** — every function is assigned the set
   of contexts it may run in, propagated to a fixpoint over the call
   graph. Context seeds: ``async def`` bodies run on the event loop
   (``loop``); callables submitted across an executor boundary run in
   that pool (``pool:<name>``, keyed on the *receiver pool identity* so
   ``self._io_pool.submit`` and ``self._pump_pool.submit`` are distinct
   contexts); ``threading.Thread`` targets run on their own thread
   (``thread:<name>``); ``call_soon``/``call_later`` callbacks stay on
   the loop. Plain sync calls inherit the caller's contexts; awaited
   calls run on the loop. The ``loop`` and each ``thread:*`` context are
   serial; every ``pool:*`` context is concurrent with itself (a pool
   has many threads).

2. **Guarded-by inference** — every attribute access recorded by the
   summaries (``self.x`` and typed-receiver chains) is keyed to its
   *defining class* (climbing the inheritance chain) and annotated with
   the canonical lockset held at the access site. The majority guard of
   an attribute is the lock held at the most write sites; the inferred
   table is generated into ``minio_tpu_torch/docs/CONCURRENCY.md`` and loaded by the
   runtime sanitizer's access witness.

3. **Race detection** — an attribute reachable from two different
   contexts (or twice from one concurrent pool context) where a write
   site and another access site share no lock is a finding, with both
   access chains printed. Reasoned suppressions keep the signal clean:

   - *init-before-spawn*: accesses inside ``__init__`` happen before the
     object escapes to other contexts;
   - *loop-confined*: attributes only touched from the (serial) event
     loop need no lock;
   - *thread-confined*: same for a single named daemon thread;
   - *atomic-read-only*: an unsynchronized READ of an attribute whose
     writes all share one guard is a GIL-atomic stale-tolerant read
     (the metrics-snapshot idiom) — reported in the guard table, not as
     a finding;
   - *thread-local classes*: classes deriving from ``threading.local``
     are per-thread by construction.

   Classes opt in the RacerD way: an attribute participates only if its
   owner class defines a lock, some access site holds a lock, or the
   owner is instantiated as a module-level singleton — per-request value
   objects never pay the pass.

Suppression: ``# miniovet: ignore[races] -- reason`` on the reported
write site (or on any access site, which declassifies that site as race
evidence).
"""

from __future__ import annotations

from collections import Counter

from .core import Finding
from .project import ProjectIndex

RULE_ID = "races"

CTX_LOOP = "loop"

# classes that are per-thread / per-task by construction
_CONFINED_BASES = ("local", "threading.local", "ContextVar")

_MAX_CHAIN = 5


class _Site:
    __slots__ = ("relpath", "line", "rw", "locks", "fn_key", "ctxs", "init")

    def __init__(self, relpath, line, rw, locks, fn_key, ctxs, init):
        self.relpath = relpath
        self.line = line
        self.rw = rw
        self.locks = locks      # frozenset of canonical lock ids
        self.fn_key = fn_key    # "mod::Qual"
        self.ctxs = ctxs        # frozenset of context ids
        self.init = init        # bool: inside an __init__ body


def _is_concurrent_pair(c1: str, c2: str) -> bool:
    """Can contexts c1 and c2 run at the same time? Distinct contexts
    always can; a pool context can also race with itself (many worker
    threads), while ``loop`` and a single named thread are serial."""
    if c1 != c2:
        return True
    return c1.startswith("pool:")


class RacesEngine:
    def __init__(self, index: ProjectIndex, suppressed):
        self.ix = index
        self.suppressed = suppressed
        self.contexts: dict[str, set[str]] = {}
        # (fn_key, ctx) -> (parent_fn_key, line, kind) for chain printing
        self.origins: dict[tuple[str, str], tuple | None] = {}
        self._resolved: dict[tuple[str, str], list[str]] = {}
        # access-path id -> leaf "module.Class.attr" the runtime witness
        # instruments (chained paths share a leaf class attribute)
        self.witness_ids: dict[str, str] = {}

    # ---- call resolution (memoized) ----

    def _resolve(self, key: str, expr: str) -> list[str]:
        memo = self._resolved.get((key, expr))
        if memo is None:
            relpath = self.ix.func_file[key]
            qual = key.split("::", 1)[1]
            memo = self.ix.resolve_call(relpath, qual, expr)
            self._resolved[(key, expr)] = memo
        return memo

    # ---- stage 1: execution contexts ----

    def infer_contexts(self) -> None:
        ctxs = self.contexts
        origins = self.origins
        work: list[str] = []

        def add(fn_key: str, ctx: str, origin) -> None:
            have = ctxs.setdefault(fn_key, set())
            if ctx not in have:
                have.add(ctx)
                origins.setdefault((fn_key, ctx), origin)
                work.append(fn_key)

        # seeds: async defs run on the loop; boundary submissions run in
        # their pool/thread regardless of whether the submitter's own
        # context is known (if the submission exists, assume it runs)
        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            if fs["async"]:
                add(key, CTX_LOOP, None)
            for c in fs["calls"]:
                kind = c["kind"]
                if kind not in ("executor", "thread", "task"):
                    continue
                via = c.get("via", "") or kind
                if kind == "executor":
                    ctx = f"pool:{via}"
                elif kind == "thread":
                    ctx = f"thread:{via}"
                else:
                    ctx = CTX_LOOP
                for tgt in self._resolve(key, c["expr"]):
                    add(tgt, ctx, (key, c["line"], kind))

        # fixpoint: sync call edges inherit the caller's contexts;
        # awaited callees run on the loop (they are async, seeded above)
        while work:
            key = work.pop()
            fs = self.ix.functions.get(key)
            if fs is None:
                continue
            here = set(ctxs.get(key, ()))
            if not here:
                continue
            for c in fs["calls"]:
                if c["kind"] != "call":
                    continue
                for tgt in self._resolve(key, c["expr"]):
                    tfs = self.ix.functions.get(tgt)
                    if tfs is None or tfs["async"]:
                        continue  # a sync frame can't run an async callee
                    for ctx in here:
                        add(tgt, ctx, (key, c["line"], "call"))

    def context_chain(self, fn_key: str, ctx: str) -> str:
        """Human-readable derivation of how `fn_key` comes to run in
        `ctx`: the boundary/call hops back to the context seed."""
        hops: list[str] = []
        cur = fn_key
        for _ in range(_MAX_CHAIN):
            origin = self.origins.get((cur, ctx))
            if origin is None:
                break
            parent, line, kind = origin
            pfs = self.ix.functions.get(parent)
            pname = pfs["name"] if pfs else parent
            prel = self.ix.func_file.get(parent, "?")
            arrow = {"call": "->", "executor": "=pool=>",
                     "thread": "=thread=>", "task": "=task=>"}[kind]
            hops.append(f"`{pname}` ({prel}:{line}) {arrow}")
            cur = parent
        hops.reverse()
        fs = self.ix.functions.get(fn_key)
        name = fs["name"] if fs else fn_key
        tail = f"`{name}`"
        return " ".join(hops + [tail]) if hops else tail

    # ---- stage 2: attribute site collection ----

    def _class_chain(self, clskey: str) -> list[str]:
        """clskey and its project ancestors, nearest first."""
        out = [clskey]
        seen = {clskey}
        frontier = [clskey]
        while frontier:
            ck = frontier.pop(0)
            ci = self.ix.classes.get(ck)
            if ci is None:
                continue
            mod = ck.split("::")[0]
            for b in ci.get("bases", ()):
                bsym = (
                    self.ix._resolve_dotted_symbol(mod, b)
                    if "." in b else self.ix._module_symbol(mod, b)
                )
                if bsym and bsym.startswith("class:"):
                    bk = bsym[6:]
                    if bk not in seen:
                        seen.add(bk)
                        out.append(bk)
                        frontier.append(bk)
        return out

    def _class_confined(self, clskey: str) -> bool:
        for ck in self._class_chain(clskey):
            ci = self.ix.classes.get(ck)
            for b in (ci or {}).get("bases", ()):
                if b in _CONFINED_BASES or b.split(".")[-1] == "local":
                    return True
        return False

    def _defining_class(self, clskey: str, attr: str) -> str:
        """Topmost project ancestor that declares `attr` (assigns it via
        self or lists it in __slots__) — the canonical owner the runtime
        witness keys on too."""
        owner = clskey
        for ck in self._class_chain(clskey):
            ci = self.ix.classes.get(ck)
            if ci and attr in ci.get("own", ()):
                owner = ck  # chain is nearest-first: keep the last hit
        return owner

    def _resolve_receiver(self, fn_key: str, recv: str) -> str | None:
        """Receiver expression at an access site -> class key, through
        self/cls, typed locals, typed module globals (singletons), and
        typed instance attributes (``self.stats.n``)."""
        got = self._resolve_receiver_path(fn_key, recv)
        return got[0] if got else None

    def _resolve_receiver_path(
        self, fn_key: str, recv: str
    ) -> tuple[str, str] | None:
        """(final class key, path-root class key): the path root is the
        class holding the FIRST attribute hop — access paths are keyed on
        it so `SetCache.fi_stats.hits` and `DataCache.stats.hits` (both
        TierStats instances) never alias."""
        fs = self.ix.functions[fn_key]
        relpath = self.ix.func_file[fn_key]
        s = self.ix.summaries.get(relpath, {})
        mod = s.get("module", "")
        parts = recv.split(".")
        clskey: str | None = None
        if parts[0] in ("self", "cls"):
            if not fs.get("class"):
                return None
            clskey = f"{mod}::{fs['class']}"
        else:
            ctor = fs.get("locals", {}).get(parts[0]) \
                or s.get("globals", {}).get(parts[0])
            if ctor is None:
                # imported singleton: `from .core import _DATA`
                tgt = s.get("imports", {}).get(parts[0])
                if tgt and not tgt.startswith("ext:") and "." in tgt:
                    owner, sym = tgt.rsplit(".", 1)
                    osum = self.ix.modules.get(owner)
                    if osum is not None:
                        ctor = osum.get("globals", {}).get(sym)
                        mod = owner
            if ctor is None:
                return None
            sym = self.ix._resolve_dotted_symbol(mod, ctor)
            if not (sym and sym.startswith("class:")):
                return None
            clskey = sym[6:]
        root = clskey
        # chain hops through typed instance attrs: self.stats.n
        for i, p in enumerate(parts[1:]):
            ci = self.ix.classes.get(clskey)
            if ci is None:
                return None
            ctor = None
            for ck in self._class_chain(clskey):
                ctor = self.ix.classes.get(ck, {}).get(
                    "attr_types", {}
                ).get(p)
                if ctor:
                    cmod = ck.split("::")[0]
                    break
            if ctor is None:
                return None
            if i == 0:
                root = self._defining_class(clskey, p)
            sym = self.ix._resolve_dotted_symbol(cmod, ctor)
            if not (sym and sym.startswith("class:")):
                return None
            clskey = sym[6:]
        return clskey, root

    def _class_locks(self, clskey: str) -> frozenset:
        """Canonical ids of the locks `clskey` (or an ancestor) defines."""
        out: set[str] = set()
        for ck in self._class_chain(clskey):
            mod, cls = ck.split("::")
            s = self.ix.modules.get(mod, {})
            for ref, canon in s.get("locks", {}).items():
                if ref.startswith(cls + "."):
                    out.add(canon)
        return frozenset(out)

    def _class_participates(self, clskey: str) -> bool:
        """RacerD-style opt-in: the class (or an ancestor) defines a
        lock, or it is instantiated as a module-level singleton."""
        if self._class_locks(clskey):
            return True
        for s in self.ix.modules.values():
            for ctor in s.get("globals", {}).values():
                sym = self.ix._resolve_dotted_symbol(
                    s["module"], ctor
                )
                if sym == f"class:{clskey}":
                    return True
        return False

    def collect_sites(self) -> dict[str, list[_Site]]:
        """attr id ("module.Class.attr") -> access sites."""
        out: dict[str, list[_Site]] = {}
        participates: dict[str, bool] = {}

        def class_part(clskey: str) -> bool:
            p = participates.get(clskey)
            if p is None:
                p = participates[clskey] = self._class_participates(clskey)
            return p

        for key in sorted(self.ix.functions):
            fs = self.ix.functions[key]
            accesses = fs.get("attrs") or ()
            if not accesses:
                continue
            relpath = self.ix.func_file[key]
            s = self.ix.summaries.get(relpath, {})
            mod = s.get("module", "")
            qual = key.split("::", 1)[1]
            meth = qual.split(".")[-1]
            is_init = meth in ("__init__", "__post_init__", "__new__")
            ctxs = frozenset(self.contexts.get(key, ()))
            # the tree's `_locked` suffix convention asserts "caller
            # holds the class lock": credit those accesses with the
            # enclosing class's own locks, same as a lexical `with`
            caller_held: frozenset = frozenset()
            if meth.endswith("_locked") and fs.get("class"):
                caller_held = self._class_locks(f"{mod}::{fs['class']}")
            for a in accesses:
                got = self._resolve_receiver_path(key, a["recv"])
                if got is None:
                    continue
                clskey, rootkey = got
                if self._class_confined(clskey) or \
                        self._class_confined(rootkey):
                    continue  # threading.local subclass: per-thread
                if len(a["recv"].split(".")) == 1 and any(
                    a["attr"] in self.ix.classes.get(ck, {}).get(
                        "methods", ()
                    )
                    for ck in self._class_chain(clskey)
                ):
                    continue  # bound-method reference (Thread target),
                    # not mutable state
                rparts = a["recv"].split(".")
                if len(rparts) == 1:
                    owner = self._defining_class(clskey, a["attr"])
                    attr_path = a["attr"]
                else:
                    # chained access: key the path on the class holding
                    # the first hop, so distinct instances of a shared
                    # value class (TierStats) never alias
                    owner = rootkey
                    attr_path = ".".join(rparts[1:] + [a["attr"]])
                # participation is per SITE: the owner class opted in
                # (defines a lock / is a singleton), the receiver chain
                # passed through an opted-in root (`self.stats.n` of a
                # lock-owning class, `_DATA.stats.n` via a module
                # singleton), or the access itself holds a lock
                root = a["recv"].split(".")[0]
                part = class_part(owner)
                if not part and "." in a["recv"]:
                    part = class_part(clskey)
                if not part and root in ("self", "cls") and fs.get("class"):
                    part = class_part(f"{mod}::{fs['class']}")
                if not part and root not in ("self", "cls"):
                    # receiver rooted at a module-level singleton
                    part = (
                        root in s.get("globals", {})
                        or any(
                            root in m.get("globals", {})
                            for m in (self.ix.modules.get(
                                self._import_owner(s, root) or "", None
                            ),) if m
                        )
                    )
                if not part and a.get("locks"):
                    part = True
                if not part:
                    continue
                if self.suppressed(relpath, a["line"], RULE_ID):
                    continue  # pragma declassifies this site as evidence
                locks = frozenset(
                    self.ix.canon_lock(relpath, qual, lk)
                    for lk in a.get("locks", ())
                ) | caller_held
                omod, ocls = owner.split("::")
                attr_id = f"{omod}.{ocls}.{attr_path}" if omod \
                    else f"{ocls}.{attr_path}"
                leaf = self._defining_class(clskey, a["attr"])
                lmod, lcls = leaf.split("::")
                self.witness_ids[attr_id] = (
                    f"{lmod}.{lcls}.{a['attr']}" if lmod
                    else f"{lcls}.{a['attr']}"
                )
                out.setdefault(attr_id, []).append(_Site(
                    relpath, a["line"], a["rw"], locks, key, ctxs, is_init,
                ))
        return out

    @staticmethod
    def _import_owner(summary: dict, name: str) -> str | None:
        tgt = summary.get("imports", {}).get(name)
        if tgt and not tgt.startswith("ext:") and "." in tgt:
            return tgt.rsplit(".", 1)[0]
        return None

    # ---- stage 3: analysis ----

    def analyze(self) -> tuple[list[Finding], list[dict]]:
        self.infer_contexts()
        sites_by_attr = self.collect_sites()
        findings: list[Finding] = []
        table: list[dict] = []
        for attr_id in sorted(sites_by_attr):
            sites = [
                s for s in sites_by_attr[attr_id]
                if not s.init and s.ctxs
            ]
            if not sites:
                continue
            all_ctxs = sorted(set().union(*(s.ctxs for s in sites)))
            writes = [s for s in sites if s.rw == "w"]
            reads = [s for s in sites if s.rw == "r"]
            # contexts must be able to overlap at all
            concurrent = any(
                _is_concurrent_pair(c1, c2)
                for i, c1 in enumerate(all_ctxs)
                for c2 in all_ctxs[i:]
            )
            # majority guard: the lock held at the most write sites
            # (falling back to read sites for read-only attrs)
            guard_votes: Counter = Counter()
            for s in (writes or sites):
                for lk in s.locks:
                    guard_votes[lk] += 1
            guard = ""
            if guard_votes:
                guard = sorted(
                    guard_votes.items(), key=lambda kv: (-kv[1], kv[0])
                )[0][0]
            # writes consistently guarded by one common lock?
            common_write_guard: frozenset = (
                frozenset.intersection(*(s.locks for s in writes))
                if writes else frozenset()
            )
            status = "confined"
            pair = None
            if not writes:
                status = "read-only"
            elif not concurrent:
                status = "confined"
            else:
                pair = self._find_racy_pair(writes, sites,
                                            common_write_guard)
                if pair is not None:
                    status = "racy"
                elif common_write_guard:
                    status = (
                        "guarded" if all(
                            s.locks & common_write_guard for s in reads
                        ) else "atomic-read"
                    )
                else:
                    status = "guarded"
            if len(all_ctxs) > 1 or concurrent:
                table.append({
                    "attr": attr_id,
                    "witness": self.witness_ids.get(attr_id, attr_id),
                    "contexts": all_ctxs,
                    "guard": guard,
                    "reads": len(reads),
                    "writes": len(writes),
                    "status": status,
                })
            if pair is not None:
                findings.append(self._finding(attr_id, all_ctxs,
                                              guard, *pair))
        return findings, table

    @staticmethod
    def _pair_concurrent(w: _Site, o: _Site) -> bool:
        if o is w:
            # one site races with itself only if its function can run
            # twice at once: two distinct contexts, or a pool context
            # (a pool has many worker threads)
            return len(w.ctxs) > 1 or any(
                c.startswith("pool:") for c in w.ctxs
            )
        return any(
            _is_concurrent_pair(c1, c2)
            for c1 in w.ctxs for c2 in o.ctxs
        )

    def _find_racy_pair(self, writes, sites, common_write_guard):
        """First (write, other) pair that can run concurrently with no
        shared lock; unsynchronized reads of consistently-guarded
        attributes are exempt (atomic-read-only)."""
        for w in sorted(writes, key=lambda s: (s.relpath, s.line)):
            for o in sorted(sites, key=lambda s: (s.rw != "w", s.relpath,
                                                  s.line)):
                if not self._pair_concurrent(w, o):
                    continue
                if w.locks & o.locks:
                    continue
                if o.rw == "r" and common_write_guard:
                    continue  # atomic-read-only: guarded writes
                return w, o
        return None

    def _finding(self, attr_id, all_ctxs, guard, w, o) -> Finding:
        def locks_s(s):
            return "{" + ", ".join(sorted(s.locks)) + "}" if s.locks \
                else "no locks"

        def ctx_s(s):
            return ", ".join(sorted(s.ctxs))

        w_chain = self.context_chain(w.fn_key, sorted(w.ctxs)[0])
        o_chain = self.context_chain(o.fn_key, sorted(o.ctxs)[0])
        kind = "write/write" if o.rw == "w" else "write/read"
        other_desc = "write" if o.rw == "w" else "unsynchronized read"
        guard_hint = (
            f"; majority guard is `{guard}`" if guard else ""
        )
        return Finding(
            w.relpath, w.line, RULE_ID,
            f"{kind} race on `{attr_id}`: write at {w.relpath}:{w.line} "
            f"in context [{ctx_s(w)}] holding {locks_s(w)} (chain: "
            f"{w_chain}) vs {other_desc} at {o.relpath}:{o.line} in "
            f"context [{ctx_s(o)}] holding {locks_s(o)} (chain: "
            f"{o_chain}); attribute is reachable from contexts "
            f"[{', '.join(all_ctxs)}] with an empty lockset "
            f"intersection{guard_hint} — hold one common lock on both "
            "sides or confine the attribute to one context",
        )


def run(index: ProjectIndex, suppressed,
        engine: "RacesEngine | None" = None
        ) -> tuple[list[Finding], list[dict]]:
    """`engine` lets run_passes share ONE engine (and its execution-
    context fixpoint) with the error-taint pass instead of computing
    the whole-program context map twice per run."""
    eng = engine if engine is not None else RacesEngine(index, suppressed)
    return eng.analyze()


def generate_concurrency_md(table: list[dict]) -> str:
    """minio_tpu_torch/docs/CONCURRENCY.md content: the inferred guarded-by table for
    every attribute reachable from more than one execution context. The
    runtime access witness (analysis/sanitizer.py) instruments these
    attributes under ``MINIO_TPU_SANITIZE=1`` and reports any live
    lockset inconsistency as an obs ``type=sanitizer`` record."""
    out = [
        "# Concurrency map — inferred guards for cross-context state",
        "",
        "Generated from the `races` interprocedural pass by",
        "`python -m minio_tpu_torch.analysis --gen-concurrency` — do not edit",
        "by hand. Every row is a mutable attribute the pass proved",
        "reachable from two or more execution contexts (event loop,",
        "executor pools, daemon threads). `guarded` = every access holds",
        "the guard; `atomic-read` = writes hold the guard, some reads",
        "ride the GIL (stale-tolerant metrics snapshots); `read-only` =",
        "no post-init writes; `confined` = contexts never overlap. The",
        "runtime access witness loads this table and reports live",
        "lockset violations on the attributes below.",
        "",
        "| Attribute | Witness target | Contexts | Inferred guard "
        "| R/W sites | Status |",
        "|---|---|---|---|---|---|",
    ]
    for row in sorted(table, key=lambda r: r["attr"]):
        guard = f"`{row['guard']}`" if row["guard"] else "_(none)_"
        ctxs = ", ".join(f"`{c}`" for c in row["contexts"])
        out.append(
            f"| `{row['attr']}` | `{row.get('witness', row['attr'])}` "
            f"| {ctxs} | {guard} "
            f"| {row['reads']}/{row['writes']} | {row['status']} |"
        )
    out.append("")
    return "\n".join(out)
