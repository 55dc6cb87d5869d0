"""minio_tpu_torch stands alone: no file of the package, nor chip_smoke.py,
imports JAX, the JAX package, or the packages the card's machine lacks
(msgpack, aiohttp); importing it pulls none of them in, nor the optional
yaml, pyarrow and cryptography; and chip_smoke.py refuses to run without a
card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "minio_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "minio_tpu", "msgpack", "aiohttp"}
# optional packages the port reaches only through lazy imports: importing
# its modules (the S3 server included) pulls none of them in
OPTIONAL = {"yaml", "pyarrow", "cryptography"}


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dp, _, fs in os.walk(PKG):
        out += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# the port's lazy relative imports of modules it lacks yet, each with why
# it is reached only off the ported paths (ROADMAP Queue 1 names when each
# module comes)
MISSING_OK = {
    ("server/metrics.py", "minio_tpu_torch.analysis"):
        "the v3 /api/sanitizer group (analysis/sanitizer.py is not ported)",
    ("server/admin.py", "minio_tpu_torch.analysis"):
        "admin sanitizer/status; it answers a named 501 NotImplemented until "
        "analysis/sanitizer.py lands",
    ("diag/healthinfo.py", "minio_tpu_torch.analysis"):
        "the healthinfo bundle (the knob registry and the sanitizer's "
        "status); admin healthinfo answers a named 501 until analysis/ lands",
}


def _module_exists(parts) -> bool:
    base = os.path.join(ROOT, *parts)
    return os.path.exists(base + ".py") or os.path.exists(os.path.join(base, "__init__.py"))


def _relative_imports(path):
    """(module, lineno) of every relative import in ``path``; for a
    ``from .pkg import name`` where name is a submodule, the submodule."""
    rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    pkg = rel[:-1]
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level == 0:
            continue
        mod = pkg[: len(pkg) - (node.level - 1)] + (node.module.split(".") if node.module else [])
        if not _module_exists(mod) or not os.path.isdir(os.path.join(ROOT, *mod)):
            yield mod, node.lineno
            continue
        init = open(os.path.join(ROOT, *mod, "__init__.py"), encoding="utf-8").read()
        for a in node.names:
            if not _module_exists(mod + [a.name]) and a.name not in init:
                yield mod + [a.name], node.lineno


def test_relative_imports_resolve_inside_the_port():
    missing = []
    for path in _files()[1:]:
        for mod, ln in _relative_imports(path):
            name = ".".join(mod)
            where = os.path.relpath(path, PKG).replace(os.sep, "/")
            if not _module_exists(mod) and (where, name) not in MISSING_OK:
                missing.append(f"{where}:{ln} -> {name}")
    assert not missing, missing
    assert all(not _module_exists(m.split(".")) for _, m in MISSING_OK)
    assert all(len(why) > 20 for why in MISSING_OK.values())


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import minio_tpu_torch.erasure.set, minio_tpu_torch.parallel.dispatcher\n"
        "import minio_tpu_torch.ops.fused_cuda, minio_tpu_torch.ops.bitrot_cuda\n"
        "import minio_tpu_torch.ops.rs_cuda, minio_tpu_torch.ops.cauchy\n"
        "import minio_tpu_torch.erasure.pools, minio_tpu_torch.erasure.multipart\n"
        "import minio_tpu_torch.placement, minio_tpu_torch.utils.checksum\n"
        "import minio_tpu_torch.erasure.background, minio_tpu_torch.erasure.decommission\n"
        "import minio_tpu_torch.ilm.tier, minio_tpu_torch.ilm.lifecycle\n"
        "import minio_tpu_torch.ilm.warm_backends, minio_tpu_torch.client\n"
        "import minio_tpu_torch.server.buckets, minio_tpu_torch.server.madmin\n"
        "import minio_tpu_torch.server.app, minio_tpu_torch.server.web\n"
        "import minio_tpu_torch.server.metrics, minio_tpu_torch.server.sts\n"
        "import minio_tpu_torch.server.kms_handlers, minio_tpu_torch.batch.jobs\n"
        "import minio_tpu_torch.s3select.engine, minio_tpu_torch.crypto.sse\n"
        "import minio_tpu_torch.iam.oidc, minio_tpu_torch.replication.site\n"
        "import minio_tpu_torch.events.targets, minio_tpu_torch.cluster.endpoint\n"
        "import minio_tpu_torch.cluster.grid, minio_tpu_torch.cluster.storage_rest\n"
        "import minio_tpu_torch.cluster.locks, minio_tpu_torch.cluster.bootstrap\n"
        "import minio_tpu_torch.crypto.tlsconf, minio_tpu_torch.diag\n"
        "import minio_tpu_torch.server.admin, minio_tpu_torch.server.profiling\n"
        "import minio_tpu_torch.server.worker, minio_tpu_torch.server.ftp\n"
        "import minio_tpu_torch.server.sftp, minio_tpu_torch.server.console\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_server_import_pulls_in_no_optional_package():
    code = (
        "import sys\n"
        "import minio_tpu_torch.server.app, minio_tpu_torch.server.metrics\n"
        "import minio_tpu_torch.batch.jobs, minio_tpu_torch.s3select.engine\n"
        "import minio_tpu_torch.crypto.sse, minio_tpu_torch.crypto.kes\n"
        "import minio_tpu_torch.server.sts, minio_tpu_torch.iam.oidc\n"
        "import minio_tpu_torch.server.admin, minio_tpu_torch.diag\n"
        "import minio_tpu_torch.cluster.grid, minio_tpu_torch.cluster.storage_rest\n"
        "import minio_tpu_torch.server.ftp, minio_tpu_torch.server.console\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(FORBIDDEN | OPTIONAL)!r}))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")), (tmp_path, None)):
        if script is None:
            script = str(tmp_path / "chip_smoke.py")
            with open(os.path.join(ROOT, "chip_smoke.py"), "rb") as src:
                open(script, "wb").write(src.read())
        out = subprocess.run([sys.executable, script], capture_output=True, text=True,
                             cwd=cwd, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
