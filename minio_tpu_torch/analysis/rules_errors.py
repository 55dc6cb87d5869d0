"""``error-taint`` — error-propagation pass for the serving path.

Every storage/TPU exception raised under a GET/PUT/HEAD must surface
somewhere a client or operator can see it: a typed S3 error mapping at
the handler boundary (server/s3err.py), the unified retry policy
(fault/retry.py), or the backend degradation ladder (the dispatcher's
TPU→XLA→numpy rungs). Two failure shapes defeat all three, and this
pass finds both over the project call graph:

1. **Broad swallows on the serving path** — a bare/``Exception``
   handler with *no raise at all* inside ``erasure/``, ``storage/``,
   ``cache/``, or ``parallel/`` converts a storage error into a normal
   return value (``None``, a default, a silently shorter list) on a
   chain a request handler can reach. Findings anchor the handler
   line. Exempt: handlers that raise anything (translation is
   propagation), broad-``try`` blocks nested inside an outer
   ``except``/``finally`` (cleanup during unwinding must not mask the
   original error), release/shutdown-shaped methods (``close``,
   ``stop``, ``__del__``, …), and functions the execution-context
   fixpoint (shared with the ``races`` pass) proves run *only* on
   background daemon threads — a scanner swallow degrades a sweep, not
   a request.

2. **Unmapped exception types** — a project-defined exception class
   raised on the serving path in ``erasure/``, ``storage/``, or
   ``parallel/`` that **no typed handler anywhere** names (``except``
   clause or ``isinstance`` dispatch, own name or any ancestor's) can
   only ever surface as a broad-except swallow or an untyped 500.
   Findings anchor the first raise site of the class.

Suppression: ``# miniovet: ignore[error-taint] -- reason`` on the
handler line (case 1) or the anchored raise line (case 2).
"""

from __future__ import annotations

from .core import Finding
from .project import ProjectIndex

RULE_ID = "error-taint"

# where the serving-path contract applies
_SWALLOW_DIRS = ("erasure/", "storage/", "cache/", "parallel/")
_RAISE_DIRS = ("erasure/", "storage/", "parallel/")

# release/shutdown-shaped methods: best-effort by design — failing to
# close must not mask the caller's real error
_CLEANUP_METHODS = frozenset({
    "close", "aclose", "stop", "shutdown", "abort", "cleanup", "teardown",
    "release", "disarm", "unsubscribe", "disconnect", "__del__",
    "__exit__", "__aexit__", "_cleanup", "clear",
})

# exception names that never need a project mapping: builtins and
# framework types whose handling is the interpreter's/runtime's business
_BUILTIN_EXCEPTIONS = frozenset({
    "Exception", "BaseException", "ValueError", "TypeError", "KeyError",
    "IndexError", "AttributeError", "RuntimeError", "OSError", "IOError",
    "FileNotFoundError", "FileExistsError", "PermissionError",
    "IsADirectoryError", "NotADirectoryError", "InterruptedError",
    "BlockingIOError", "BrokenPipeError", "ConnectionError",
    "ConnectionResetError", "ConnectionAbortedError",
    "ConnectionRefusedError", "TimeoutError", "NotImplementedError",
    "StopIteration", "StopAsyncIteration", "GeneratorExit",
    "KeyboardInterrupt", "SystemExit", "AssertionError", "MemoryError",
    "OverflowError", "ZeroDivisionError", "ArithmeticError",
    "UnicodeDecodeError", "UnicodeEncodeError", "BufferError",
    "EOFError", "LookupError", "CancelledError", "InvalidStateError",
})


class ErrorsEngine:
    def __init__(self, index: ProjectIndex, suppressed,
                 contexts: dict | None = None):
        self.ix = index
        self.suppressed = suppressed
        self._contexts = contexts  # precomputed fn-key -> context set

    # ---- execution contexts (shared inference with the races pass) ----

    def _serving_contexts(self) -> dict[str, bool]:
        """fn key -> can it run on a request-serving context? The event
        loop and every executor pool serve requests; a dedicated daemon
        thread does not — EXCEPT the dispatcher thread, which foreground
        callers park on (`submit(...).result()`). Functions the fixpoint
        never reached (dynamic dispatch the resolver can't see) DEFAULT
        TO SERVING inside the scoped dirs: an unproven caller is not an
        exemption — only a proven daemon confinement is. run_passes
        hands in the races pass's already-computed context map when both
        passes run; standalone runs compute their own."""
        contexts = self._contexts
        if contexts is None:
            from .rules_races import RacesEngine

            eng = RacesEngine(self.ix, lambda *_: False)
            eng.infer_contexts()
            contexts = eng.contexts
        out: dict[str, bool] = {}
        for key, ctxs in contexts.items():
            out[key] = any(
                c == "loop" or c.startswith("pool:")
                or (c.startswith("thread:") and "dispatch" in c)
                for c in ctxs
            )
        return out

    @staticmethod
    def _is_serving(serving: dict[str, bool], key: str) -> bool:
        return serving.get(key, True)

    # ---- pass 1: broad swallows ----

    def swallow_findings(self, serving: dict[str, bool]) -> list[Finding]:
        findings = []
        for key in sorted(self.ix.functions):
            relpath = self.ix.func_file[key]
            if not relpath.startswith(_SWALLOW_DIRS):
                continue
            fs = self.ix.functions[key]
            swallows = fs.get("swallows") or ()
            if not swallows:
                continue
            meth = fs["name"].split(".<locals>.")[-1].split(".")[-1]
            if meth in _CLEANUP_METHODS:
                continue
            if not self._is_serving(serving, key):
                continue  # PROVEN daemon-confined: exempt
            for sw in swallows:
                if sw.get("cleanup"):
                    continue
                if self.suppressed(relpath, sw["line"], RULE_ID):
                    continue
                findings.append(Finding(
                    relpath, sw["line"], RULE_ID,
                    f"broad except in `{fs['name']}` swallows a "
                    "serving-path error into a normal return — the "
                    "client sees a default instead of a typed failure; "
                    "re-raise, translate to a typed error "
                    "(server/s3err.py), or route through the retry "
                    "policy / degradation ladder (docs/ANALYSIS.md)",
                ))
        return findings

    # ---- pass 2: unmapped exception types ----

    def _exception_class(self, key: str, dotted: str) -> str | None:
        """Resolve a raised expression to a project class key, or None
        for builtins / unresolvable (re-raised locals, APIError
        singletons — those are mapped by construction)."""
        name = dotted.split(".")[-1]
        if name in _BUILTIN_EXCEPTIONS:
            return None
        relpath = self.ix.func_file[key]
        s = self.ix.summaries.get(relpath, {})
        mod = s.get("module", "")
        sym = (
            self.ix._resolve_dotted_symbol(mod, dotted)
            if "." in dotted else self.ix._module_symbol(mod, dotted)
        )
        if sym and sym.startswith("class:"):
            return sym[6:]
        return None

    def _ancestor_names(self, clskey: str) -> list[str]:
        out = []
        seen = {clskey}
        frontier = [clskey]
        while frontier:
            ck = frontier.pop(0)
            out.append(ck.split("::")[-1].split(".")[-1])
            ci = self.ix.classes.get(ck)
            if ci is None:
                continue
            mod = ck.split("::")[0]
            for b in ci.get("bases", ()):
                out.append(b.split(".")[-1])
                bsym = (
                    self.ix._resolve_dotted_symbol(mod, b)
                    if "." in b else self.ix._module_symbol(mod, b)
                )
                if bsym and bsym.startswith("class:") \
                        and bsym[6:] not in seen:
                    seen.add(bsym[6:])
                    frontier.append(bsym[6:])
        return out

    def unmapped_findings(self, serving: dict[str, bool]) -> list[Finding]:
        # every typed handler name in the whole tree (except clauses +
        # isinstance dispatch); APIError subclasses are mapped by being
        # the S3 wire format itself
        caught: set[str] = set()
        for fs in self.ix.functions.values():
            caught.update(fs.get("catches", ()))
        first_raise: dict[str, tuple[str, int, str]] = {}
        for key in sorted(self.ix.functions):
            relpath = self.ix.func_file[key]
            if not relpath.startswith(_RAISE_DIRS):
                continue
            if not self._is_serving(serving, key):
                continue
            fs = self.ix.functions[key]
            for r in fs.get("raises", ()):
                clskey = self._exception_class(key, r["type"])
                if clskey is None:
                    continue
                cur = first_raise.get(clskey)
                site = (relpath, r["line"], key)
                if cur is None or site[:2] < cur[:2]:
                    first_raise[clskey] = site
        findings = []
        for clskey in sorted(first_raise):
            names = self._ancestor_names(clskey)
            if any(n in caught for n in names) or "APIError" in names:
                continue
            relpath, line, key = first_raise[clskey]
            if self.suppressed(relpath, line, RULE_ID):
                continue
            cls = clskey.split("::")[-1]
            findings.append(Finding(
                relpath, line, RULE_ID,
                f"exception `{cls}` raised on the serving path is never "
                "caught by a typed handler anywhere in the tree (no "
                "except clause or isinstance dispatch names it or an "
                "ancestor) — it can only surface as a broad-except "
                "swallow or an untyped 500; map it at the handler "
                "boundary (server/s3err.py), the retry policy, or the "
                "degradation ladder",
            ))
        return findings

    def analyze(self) -> list[Finding]:
        serving = self._serving_contexts()
        findings = self.swallow_findings(serving)
        findings.extend(self.unmapped_findings(serving))
        findings.sort()
        return findings


def run(index: ProjectIndex, suppressed,
        contexts: dict | None = None) -> list[Finding]:
    return ErrorsEngine(index, suppressed, contexts=contexts).analyze()
