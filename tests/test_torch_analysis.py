"""The port's static gate: miniovet (``minio_tpu_torch/analysis/``) over
``minio_tpu_torch/``, strict, clean; its five generated tables in
``minio_tpu_torch/docs/`` in sync; the CLI's contract.

This module also holds ``load_reference_tests``, which the other
``test_torch_analysis_*.py`` files and ``test_torch_sanitizer.py`` use to
run the JAX package's own analysis test cases against the port: each
reference test module is parsed, its imports of ``minio_tpu`` pointed at
``minio_tpu_torch`` (and the package's name in its strings with them),
and executed into the port test module's namespace. Its entry points
into the analyzer (``analyze_source``, ``analyze_project``,
``analyze_paths``, ``scan_native_source``) are replaced by ``Both``:
each call runs the port's analyzer and the reference's on the same
input (the fixture as the reference test wrote it) and fails unless the
two give the same findings, rule, line and message, up to the package's
name. The port's result is what the reference's assertions then check.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest

import minio_tpu_torch
from minio_tpu_torch.analysis.knobs import KNOBS, generate_config_md
from minio_tpu_torch.analysis.project import analyze_project

PKG_DIR = os.path.dirname(minio_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)
DOCS = os.path.join(PKG_DIR, "docs")
REF_PKG_DIR = os.path.join(ROOT, "minio_tpu")

# fixture relpaths of the reference's device hot path -> the port's
# counterparts (the port's hostsync covers ops/*_torch.py, ops/*_cuda.py)
HOT_PATHS = {
    "ops/rs_jax.py": "ops/rs_torch.py",
    "ops/bitrot_jax.py": "ops/bitrot_torch.py",
}
# the port's wording of a reference message -> the reference's
MESSAGES = (
    ("device hot path", "TPU hot path"),
    ("use dtype=np.uint8 (torch.uint8 for a tensor)", "use dtype=np.uint8"),
    ("minio_tpu_torch/docs/", "docs/"),
)


def to_port(text: str) -> str:
    """A reference test's string as the port's test writes it."""
    text = HOT_PATHS.get(text, text)
    return re.sub(r"\bminio_tpu\b", "minio_tpu_torch", text)


def to_reference(text: str) -> str:
    """Inverse of ``to_port``: the fixture as the reference test wrote it."""
    text = {v: k for k, v in HOT_PATHS.items()}.get(text, text)
    return re.sub(r"\bminio_tpu_torch\b", "minio_tpu", text)


def _same_words(text: str) -> str:
    for port, ref in MESSAGES:
        text = text.replace(port, ref)
    return to_reference(text)


class _ToPort(ast.NodeTransformer):
    """A reference test module's imports and strings as the port's.

    ``modules`` maps a whole ``from M import ...`` by module (and renames
    the names it lists); ``names`` maps single names, keyed by their
    dotted path, to (module, name): such a name is split out of its
    statement, and the statement's other names keep the mapping by
    module (``from minio_tpu.ops import rs, rs_jax`` keeps ``rs`` the
    port's own)."""

    def __init__(self, modules: dict[str, tuple[str, dict[str, str]]],
                 names: dict[str, tuple[str, str]] | None = None):
        self.modules = modules
        self.names = names or {}

    def visit_Import(self, node):
        for a in node.names:
            if a.name == "minio_tpu":
                a.name, a.asname = "minio_tpu_torch", a.asname or "minio_tpu"
            elif a.name.startswith("minio_tpu."):
                a.name = to_port(a.name)
        return node

    def visit_ImportFrom(self, node):
        split = [a for a in node.names
                 if node.level == 0 and f"{node.module}.{a.name}" in self.names]
        if split:
            out = []
            for a in split:
                module, name = self.names[f"{node.module}.{a.name}"]
                out.append(ast.copy_location(ast.ImportFrom(
                    module=module, names=[ast.alias(name=name, asname=a.asname or a.name)],
                    level=0), node))
            node.names = [a for a in node.names if a not in split]
            return ([self.visit_ImportFrom(node)] if node.names else []) + out
        if node.level == 0 and node.module in self.modules:
            node.module, names = self.modules[node.module]
            for a in node.names:
                if a.name in names:
                    a.name, a.asname = names[a.name], a.asname or a.name
        elif node.level == 0 and node.module and node.module.split(".")[0] == "minio_tpu":
            node.module = to_port(node.module)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = to_port(node.value)
        return node


def _mirror(paths: list[str], into: str) -> list[str]:
    """Copy the fixture trees at ``paths`` under ``into`` as the reference
    test wrote them (directory names and sources through to_reference)."""
    out = []
    for p in paths:
        dest = os.path.join(into, to_reference(os.path.abspath(p)).lstrip(os.sep))
        if os.path.isdir(p):
            for dp, dns, fns in os.walk(p):
                dns[:] = [d for d in dns if d != "__pycache__"]
                for fn in fns:
                    src = os.path.join(dp, fn)
                    rel = to_reference(os.path.relpath(src, p))
                    _copy_text(src, os.path.join(dest, rel))
        elif os.path.exists(p):
            _copy_text(p, dest)
        out.append(dest)
    return out


def _copy_text(src: str, dest: str) -> None:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if src.endswith(".py"):
        with open(src, encoding="utf-8") as fh, open(dest, "w", encoding="utf-8") as out:
            out.write(to_reference(fh.read()))
    else:
        shutil.copyfile(src, dest)


class Both:
    """The analyzer's entry points, each run through both packages."""

    def __init__(self):
        from minio_tpu.analysis import core as ref_core
        from minio_tpu.analysis import project as ref_project
        from minio_tpu.analysis import rules_native as ref_native
        from minio_tpu_torch.analysis import core, project, rules_native

        self.port = (core, project, rules_native)
        self.ref = (ref_core, ref_project, ref_native)
        self.calls = 0

    @staticmethod
    def _key(findings, strip: str = "") -> list:
        return sorted(
            (_same_words(f.file.replace(strip, "") if strip else f.file), f.line, f.rule,
             _same_words(f.message.replace(strip, "") if strip else f.message))
            for f in findings
        )

    def analyze_source(self, source, path="<string>", rules=None, relpath=None):
        got = self.port[0].analyze_source(source, path=path, rules=rules, relpath=relpath)
        want = self.ref[0].analyze_source(
            to_reference(source), path=to_reference(path), rules=rules,
            relpath=None if relpath is None else to_reference(relpath))
        assert self._key(got) == self._key(want), (got, want)
        self.calls += 1
        return got

    def scan_native_source(self, source, path):
        got = self.port[2].scan_native_source(source, path)
        want = self.ref[2].scan_native_source(to_reference(source), to_reference(path))
        assert self._key(got) == self._key(want), (got, want)
        self.calls += 1
        return got

    def analyze_project(self, paths, rules=None, jobs=1, cache_path=None):
        paths = [str(p) for p in paths]
        got = self.port[1].analyze_project(paths, rules=rules, jobs=jobs, cache_path=cache_path)
        own = [p for p in paths if os.path.abspath(p).startswith((PKG_DIR + os.sep, REF_PKG_DIR + os.sep))
               or os.path.abspath(p) in (PKG_DIR, REF_PKG_DIR)]
        if own:
            return got  # a package's own tree: the port's facts, checked by the caller
        with tempfile.TemporaryDirectory() as tmp:
            want = self.ref[1].analyze_project(_mirror(paths, tmp), rules=rules, jobs=1)
            assert self._key(got.findings) == self._key(want.findings, tmp), (
                got.findings, want.findings)
            for table in ("lock_order", "lock_edges", "guard_table", "resource_table"):
                mine = _same_words(json.dumps(getattr(got, table), sort_keys=True))
                theirs = _same_words(json.dumps(getattr(want, table), sort_keys=True).replace(tmp, ""))
                assert mine == theirs, table
        self.calls += 1
        return got

    def analyze_paths(self, paths, rules=None, jobs=1, cache_path=None):
        return self.analyze_project(paths, rules=rules, jobs=jobs, cache_path=cache_path).findings


ANALYZER_ENTRIES = ("analyze_source", "analyze_project", "analyze_paths", "scan_native_source")


def load_reference_tests(name: str, namespace: dict, replaced: dict[str, str],
                         modules: dict[str, tuple[str, dict[str, str]]] | None = None,
                         names: dict[str, tuple[str, str]] | None = None) -> Both | None:
    """Execute ``tests/<name>.py`` into ``namespace`` with its imports and
    strings pointed at the port, and its analyzer entry points through
    ``Both`` (built only for a suite that has one: ``Both`` imports the
    reference's analyzer). ``replaced`` names the cases the port's module
    then defines anew (each with why the reference's body cannot hold for
    the port); the reference's own are kept in the namespace's
    ``REFERENCE_CASES``. ``modules`` maps other imports, module to
    (module, {name: name}): the reference's test helpers to the port's;
    ``names`` maps single imported names (``_ToPort``)."""
    path = os.path.join(ROOT, "tests", f"{name}.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    tree = ast.fix_missing_locations(_ToPort(modules or {}, names).visit(tree))
    exec(compile(tree, path, "exec"), namespace)
    both = None
    if any(entry in namespace for entry in ANALYZER_ENTRIES):
        both = Both()
        for entry in ANALYZER_ENTRIES:
            if entry in namespace:
                namespace[entry] = getattr(both, entry)
    reference = namespace.setdefault("REFERENCE_CASES", {})
    for case in replaced:
        assert case in namespace, f"{name} has no case {case}"
        reference[case] = namespace.pop(case)
    return both


def check_replaced(namespace: dict, replaced: dict[str, str], here: str) -> None:
    """Every replaced reference case has its counterpart in ``here``."""
    for case, why in replaced.items():
        fn = namespace.get(case)
        assert fn is not None and fn.__code__.co_filename == here, case
        assert len(why) > 20, case


# -- the gate over the port --------------------------------------------------


@pytest.fixture(scope="module")
def project_result():
    # one whole-program run shared by the gate assertions below
    return analyze_project([PKG_DIR])


def test_port_is_clean(project_result):
    findings = project_result.findings
    assert findings == [], "\n" + "\n".join(str(f) for f in findings)


def _generated(project_result, table: str) -> str:
    if table == "CONFIG.md":
        return generate_config_md() + "\n"
    if table == "LOCK_ORDER.md":
        from minio_tpu_torch.analysis.interproc import generate_lock_order_md

        return generate_lock_order_md(project_result.lock_order, project_result.lock_edges)
    if table == "CONCURRENCY.md":
        from minio_tpu_torch.analysis.rules_races import generate_concurrency_md

        return generate_concurrency_md(project_result.guard_table)
    if table == "RESOURCES.md":
        from minio_tpu_torch.analysis.rules_resources import generate_resources_md

        return generate_resources_md(project_result.resource_table)
    from minio_tpu_torch.analysis.rules_surface import generate_surface_md

    return generate_surface_md(project_result.surface)


TABLES = ["CONFIG.md", "LOCK_ORDER.md", "CONCURRENCY.md", "RESOURCES.md", "SURFACE.md"]


@pytest.mark.parametrize("table", TABLES)
def test_generated_table_in_sync(project_result, table):
    with open(os.path.join(DOCS, table), encoding="utf-8") as fh:
        on_disk = fh.read()
    assert on_disk == _generated(project_result, table), (
        f"minio_tpu_torch/docs/{table} is stale; regenerate with "
        "`python -m minio_tpu_torch.analysis --gen-...` (README)"
    )
    assert "minio_tpu_torch" in on_disk or table in ("LOCK_ORDER.md", "CONCURRENCY.md")


def test_tables_name_the_port(project_result):
    # generated from the port's sources, for the port's runtime witness
    lock_order = open(os.path.join(DOCS, "LOCK_ORDER.md"), encoding="utf-8").read()
    assert "python -m minio_tpu_torch.analysis --gen-lock-order" in lock_order
    ranks = re.findall(r"^\|\s*\d+\s*\|", lock_order, re.M)
    assert len(ranks) == len(project_result.lock_order) > 50
    resources = open(os.path.join(DOCS, "RESOURCES.md"), encoding="utf-8").read()
    assert "minio_tpu/" not in resources.replace("minio_tpu_torch/", "")


def test_resource_table_covers_known_ownership(project_result):
    # the port's counterpart of the reference's: open_object's ns-lock
    # handle transfers into ObjectHandle, mutations release their own
    rows = {(r["function"], r["kind"]): r for r in project_result.resource_table}
    assert rows[("ErasureSet.open_object", "nslock")]["ownership"] == "transferred"
    assert rows[("ErasureSet.put_object", "nslock")]["ownership"] == "released"
    assert rows[("ErasureSet.delete_object", "nslock")]["ownership"] == "released"


def test_concurrency_table_names_the_device_dispatch_thread(project_result):
    # the dispatcher's thread is named f"device-dispatch-{d}+{p}": the
    # execution-context pass keys it on the f-string's constant head
    contexts = {c for r in project_result.guard_table for c in r["contexts"]}
    assert "thread:device-dispatch-" in contexts
    assert not any("tpu-dispatch" in c for c in contexts)
    rows = {r["attr"]: r for r in project_result.guard_table}
    calls = rows["cluster.grid.GridClient._calls"]
    assert calls["status"] == "guarded"
    assert calls["guard"] == "cluster.grid.GridClient._lock"


def test_lock_order_covers_cross_subsystem_edges(project_result):
    order = project_result.lock_order
    assert "nslock" in order
    assert order.index("nslock") < order.index("cache.core.SetCache._mu")


def test_knob_registry_describes_the_port():
    assert KNOBS["MINIO_TPU_BACKEND"].default == "torch"
    assert "numpy" in KNOBS["MINIO_TPU_BACKEND"].description
    assert KNOBS["MINIO_TPU_TORCH_DEVICE"].default == "cuda"
    assert "MINIO_TPU_PALLAS" not in KNOBS
    from minio_tpu.analysis.knobs import KNOBS as REF_KNOBS

    # every other knob keeps the reference's name and default
    same = set(KNOBS) & set(REF_KNOBS)
    assert set(REF_KNOBS) - same == {"MINIO_TPU_PALLAS"}
    assert set(KNOBS) - same == {"MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_TRACE_RING"}
    assert all(KNOBS[k].default == REF_KNOBS[k].default for k in same - {"MINIO_TPU_BACKEND"})


def test_cli_exit_codes_and_format(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("import asyncio\n\nasync def f():\n    await asyncio.sleep(0)\n")
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", str(clean)],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", str(bad)],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 1
    line = r.stdout.strip().splitlines()[0]
    assert line.startswith(f"{bad}:4: blocking: "), line


def test_cli_strict_on_the_port_and_a_seeded_violation(tmp_path):
    # the whole package, strict, as README gives it: exit 0
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", "--strict"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "miniovet: 0 findings" in r.stderr
    # a copy of the package with one host sync seeded in the dispatcher
    copy = tmp_path / "minio_tpu_torch"
    shutil.copytree(PKG_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))
    disp = copy / "parallel" / "dispatcher.py"
    src = disp.read_text()
    src += "\n\ndef _seeded(t):\n    return t.cpu()\n"
    disp.write_text(src)
    line = src.count("\n")
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", "--strict",
                        "--select", "hostsync", str(copy)],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 1, r.stdout + r.stderr
    assert r.stdout.strip().splitlines() == [
        f"{disp}:{line}: hostsync: `.cpu()` in device hot path `_seeded` forces a host "
        "sync; keep data device-resident or move the materialization to a whitelisted "
        "batch boundary"
    ]


def test_gen_refuses_a_tree_with_findings(tmp_path):
    copy = tmp_path / "minio_tpu_torch"
    shutil.copytree(PKG_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))
    (copy / "server" / "seeded.py").write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    out = tmp_path / "LOCK_ORDER.md"
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", str(copy),
                        "--gen-lock-order", str(out)],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 1
    assert "refusing to generate docs" in r.stderr
    assert not out.exists()


def test_gen_defaults_write_inside_the_package():
    from minio_tpu_torch.analysis import __main__ as cli

    assert cli._doc("LOCK_ORDER.md") == os.path.join(DOCS, "LOCK_ORDER.md")
    r = subprocess.run([sys.executable, "-m", "minio_tpu_torch.analysis", "--gen-config-docs", "-"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0
    assert r.stdout == open(os.path.join(DOCS, "CONFIG.md"), encoding="utf-8").read()


def test_default_cache_lives_in_the_package_and_is_ignored():
    from minio_tpu.analysis.project import default_cache_path as ref_cache
    from minio_tpu_torch.analysis.project import default_cache_path

    path = default_cache_path()
    assert os.path.dirname(path) == PKG_DIR
    assert path != ref_cache()
    r = subprocess.run(["git", "check-ignore", "-q", path], cwd=ROOT, timeout=30)
    assert r.returncode in (0, 128)  # 128: not a git checkout
