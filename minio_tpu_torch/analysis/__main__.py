"""miniovet CLI.

    python -m minio_tpu_torch.analysis [paths...] [--strict] [--select rule[,rule]]
                                 [--format text|json|sarif] [--jobs N]
                                 [--cache [PATH] | --no-cache] [--clean-cache]
    python -m minio_tpu_torch.analysis --gen-config-docs [PATH]
    python -m minio_tpu_torch.analysis --gen-lock-order [PATH]
    python -m minio_tpu_torch.analysis --gen-concurrency [PATH]
    python -m minio_tpu_torch.analysis --gen-resources [PATH]
    python -m minio_tpu_torch.analysis --gen-surface [PATH]
    python -m minio_tpu_torch.analysis --list-rules

Findings print as ``file:line: rule: message`` (clickable); exit status
is non-zero when anything is found. ``--strict`` additionally fails on
unused ``# miniovet: ignore[...]`` pragmas. With no paths, the installed
``minio_tpu_torch`` package is analyzed — per-file rules plus the
interprocedural passes (blocking-reachable, lock-order, coherence-path,
cancellation-reachable, races, resources, error-taint, dead-knob,
surface) over the whole program.

``--cache`` keeps per-file summaries in a content-hash-keyed JSON file
(default ``.miniovet-cache.json`` inside the package) so warm runs
re-parse only changed files; any change to the analysis package itself
busts every entry. ``--clean-cache`` deletes it first.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import ALL_RULES
from .knobs import generate_config_md
from .project import INTERPROC_PASSES, analyze_project, default_cache_path

# the generated tables live inside the package (minio_tpu_torch/docs/):
# the repository's docs/ are the reference package's
_DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")


def _doc(name: str) -> str:
    return os.path.join(_DOCS, name)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="miniovet", description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument(
        "--strict", action="store_true",
        help="also fail on unused ignore-pragmas",
    )
    ap.add_argument(
        "--select", default=None,
        help="comma-separated rule/pass ids to run (default: all)",
    )
    ap.add_argument(
        "--format", default="text", choices=("text", "json", "sarif"),
        help="finding output format (default: text)",
    )
    ap.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="parallel per-file analysis processes (default: 1)",
    )
    ap.add_argument(
        "--cache", action="store_true",
        help="use the incremental summary cache",
    )
    ap.add_argument(
        "--cache-file", default=None, metavar="PATH",
        help="cache location (implies --cache; default: "
             ".miniovet-cache.json inside the package)",
    )
    ap.add_argument(
        "--no-cache", action="store_true",
        help="ignore and do not write the incremental cache",
    )
    ap.add_argument(
        "--clean-cache", action="store_true",
        help="delete the incremental cache before analyzing",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="list rule ids and exit"
    )
    ap.add_argument(
        "--gen-config-docs", nargs="?", const=_doc("CONFIG.md"), default=None,
        metavar="PATH",
        help="write minio_tpu_torch/docs/CONFIG.md from the knob registry and exit "
             "('-' prints to stdout)",
    )
    ap.add_argument(
        "--gen-lock-order", nargs="?", const=_doc("LOCK_ORDER.md"),
        default=None, metavar="PATH",
        help="write the canonical lock-ordering table proved cycle-free "
             "by the lock-order pass and exit ('-' prints to stdout)",
    )
    ap.add_argument(
        "--gen-concurrency", nargs="?", const=_doc("CONCURRENCY.md"),
        default=None, metavar="PATH",
        help="write the guarded-by table inferred by the races pass "
             "(the runtime access witness loads it) and exit "
             "('-' prints to stdout)",
    )
    ap.add_argument(
        "--gen-resources", nargs="?", const=_doc("RESOURCES.md"),
        default=None, metavar="PATH",
        help="write the resource ownership table proved by the "
             "resources pass (the runtime leak witness cross-validates "
             "it) and exit ('-' prints to stdout)",
    )
    ap.add_argument(
        "--gen-surface", nargs="?", const=_doc("SURFACE.md"),
        default=None, metavar="PATH",
        help="write the observable-surface inventory extracted by the "
             "surface pass (metrics, routes, traces, fault boundaries) "
             "and exit ('-' prints to stdout)",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule_id in sorted(set(ALL_RULES) | set(INTERPROC_PASSES)):
            print(rule_id)
        return 0

    if args.gen_config_docs is not None:
        return _write_doc(
            args.gen_config_docs, generate_config_md() + "\n"
        )

    paths = args.paths or [os.path.dirname(os.path.dirname(__file__))]
    rules = None
    if args.select:
        rules = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = set(rules) - set(ALL_RULES) - set(INTERPROC_PASSES)
        if unknown:
            ap.error(f"unknown rules: {', '.join(sorted(unknown))}")
        if args.gen_lock_order is not None and "lock-order" not in rules:
            # the doc IS the lock-order pass's output — a selection that
            # skips the pass would silently write an empty table the
            # runtime witness then loads as "no ordering to check"
            rules.append("lock-order")
        if args.gen_concurrency is not None and "races" not in rules:
            # same contract for the guarded-by table
            rules.append("races")
        if args.gen_resources is not None and "resources" not in rules:
            # and for the ownership table
            rules.append("resources")
        if args.gen_surface is not None and "surface" not in rules:
            # and for the observable-surface inventory
            rules.append("surface")

    cache_path = None
    if (args.cache or args.cache_file) and not args.no_cache:
        cache_path = args.cache_file or default_cache_path()
    if args.clean_cache:
        # an explicit --cache-file scopes the clean to that file (even
        # under --no-cache); only a default-cache run may delete the
        # shared default cache
        cp = args.cache_file or cache_path or default_cache_path()
        if os.path.exists(cp):
            os.unlink(cp)
            print(f"removed {cp}", file=sys.stderr)
        # bare `--clean-cache` (no paths, no cache to rebuild, no doc to
        # generate) is a standalone "delete the cache" command; explicit
        # paths always analyze — deleting the cache must never skip them
        if not args.paths and cache_path is None \
                and args.gen_lock_order is None \
                and args.gen_concurrency is None \
                and args.gen_resources is None \
                and args.gen_surface is None:
            return 0

    result = analyze_project(
        paths, rules=rules, jobs=max(args.jobs, 1), cache_path=cache_path
    )

    if args.gen_lock_order is not None or args.gen_concurrency is not None \
            or args.gen_resources is not None or args.gen_surface is not None:
        gate = result.findings
        if not args.strict:  # same pragma filtering as the normal path
            gate = [f for f in gate if f.rule != "pragma"]
        if gate:
            for f in sorted(gate):
                print(f, file=sys.stderr)
            print(
                "miniovet: refusing to generate docs from a tree with "
                "findings", file=sys.stderr,
            )
            return 1
        rc = 0
        if args.gen_lock_order is not None:
            from .interproc import generate_lock_order_md

            rc = _write_doc(
                args.gen_lock_order,
                generate_lock_order_md(result.lock_order, result.lock_edges),
            )
        if args.gen_concurrency is not None and rc == 0:
            from .rules_races import generate_concurrency_md

            rc = _write_doc(
                args.gen_concurrency,
                generate_concurrency_md(result.guard_table),
            )
        if args.gen_resources is not None and rc == 0:
            from .rules_resources import generate_resources_md

            rc = _write_doc(
                args.gen_resources,
                generate_resources_md(result.resource_table),
            )
        if args.gen_surface is not None and rc == 0:
            from .rules_surface import generate_surface_md

            rc = _write_doc(
                args.gen_surface,
                generate_surface_md(result.surface),
            )
        return rc

    findings = result.findings
    if not args.strict and rules is None:
        findings = [f for f in findings if f.rule != "pragma"]

    if args.format == "json":
        from .output import findings_json

        sys.stdout.write(findings_json(findings, result.stats))
    elif args.format == "sarif":
        from .output import findings_sarif

        sys.stdout.write(findings_sarif(findings))
    else:
        for f in findings:
            print(f)

    n = len(findings)
    s = result.stats
    rule_word = "finding" if n == 1 else "findings"
    print(
        f"miniovet: {n} {rule_word} "
        f"({s['files']} files, {s['cached']} cached, "
        f"{s['total_s']:.2f}s = {s['perfile_s']:.2f}s per-file "
        f"+ {s['interproc_s']:.2f}s interproc)",
        file=sys.stderr,
    )
    return 1 if findings else 0


def _write_doc(dest: str, content: str) -> int:
    if dest == "-":
        sys.stdout.write(content)
        return 0
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "w", encoding="utf-8") as fh:
        fh.write(content)
    print(f"wrote {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
