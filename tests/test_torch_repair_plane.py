"""The reference's ``tests/test_repair_plane.py``, run as written against
the port (``tests/test_torch_suites.py``)."""

import ast
import os
import re

from tests.test_torch_suites import check_replaced, load_port_suite

REPLACED: dict[str, str] = {
    "test_keyspace_shapes_unique_and_wellformed":
        "checks the benchmark engine's key generators (benchmarks/scenarios/engine.py, not "
        "ported in this round), and importing that module loads the reference's "
        "server.signature; the port's case runs the same checks on the two functions "
        "taken from the engine's source alone",
}

load_port_suite("test_repair_plane", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


def _engine_functions(*names: str) -> dict:
    """The named top-level functions of benchmarks/scenarios/engine.py,
    compiled from its source without importing the module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "benchmarks", "scenarios", "engine.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns: dict = {}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return {n: ns[n] for n in names}


def test_keyspace_shapes_unique_and_wellformed():
    fns = _engine_functions("hive_keys", "timestamp_run_keys")
    hive_keys, timestamp_run_keys = fns["hive_keys"], fns["timestamp_run_keys"]

    hv = hive_keys(24)
    assert len(hv) == 24 and len(set(hv)) == 24
    pat = re.compile(r"^dt=2026-07-\d{2}/hour=\d{2}/part-\d{5}\.parquet$")
    assert all(pat.match(k) for k in hv), hv[:3]

    ts = timestamp_run_keys(37, runs=8)
    assert len(ts) == 37 and len(set(ts)) == 37
    pat2 = re.compile(r"^events/run\d{2}/\d+-\d{6}\.log$")
    assert all(pat2.match(k) for k in ts), ts[:3]
    run0 = [k for k in ts if k.startswith("events/run00/")]
    assert run0 == sorted(run0)

