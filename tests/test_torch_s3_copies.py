"""The S3 core's modules are copies of the JAX package's, with their
imports pointed at the port: each port module's syntax tree equals the
reference's, definition by definition, once docstrings are dropped and
the one rewrite every handler module takes (``from aiohttp import web``
becomes ``from . import web``, the port's stdlib front) is applied. The
definitions that differ on purpose are named below, each with its reason;
any other difference fails.
"""

from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "crypto/sse.py", "crypto/kes.py", "crypto/minkms.py", "crypto/x509util.py",
    "iam/policy.py", "iam/sys.py", "iam/oidc.py", "iam/etcd.py", "iam/ldap.py",
    "events/notify.py", "events/targets.py", "events/kafka.py", "events/dbsinks.py",
    "replication/replicate.py", "replication/site.py",
    "batch/jobs.py",
    "s3select/sql.py", "s3select/engine.py",
    "server/transforms.py", "server/streaming.py", "server/cors.py", "server/audit.py",
    "server/config_kv.py", "server/handler_utils.py",
    "server/auth.py", "server/postpolicy.py", "server/sts.py", "server/kms_handlers.py",
    "server/bucket_handlers.py", "server/multipart_handlers.py",
    "server/object_handlers.py", "server/metrics.py", "server/app.py",
    "cluster/endpoint.py",
]

# (module, definition) -> why the port differs there
DELIBERATE = {
    ("crypto/sse.py", "<module>"):
        "no module-top import of the optional cryptography package: importing "
        "the server pulls in no optional package",
    ("crypto/sse.py", "_aesgcm"):
        "imports AESGCM at first use instead (same typed error without it)",
    ("batch/jobs.py", "<module>"):
        "no module-top `import yaml`: yaml is needed only to submit a job",
    ("batch/jobs.py", "BatchJobPool.start"):
        "imports yaml where a job definition is parsed",
    ("server/app.py", "<module>"):
        "no `if __name__ == '__main__': main()` block, as main() is not here",
    ("server/app.py", "main"):
        "main() builds the storage/lock REST servers, the grid, bootstrap, the "
        "worker pool and TLS; it comes with the port's cluster/ slice",
    ("server/app.py", "S3Server._entry_inner"):
        "/minio/console answers NotImplemented (501, S3 XML) while the port "
        "has no console.py",
    ("server/app.py", "S3Server._dispatch"):
        "/minio/admin/ answers NotImplemented (501, S3 XML) while the port "
        "has no admin.py",
    ("server/app.py", "make_object_layer"):
        "imports StorageRESTClient in the remote-drive branch only (the port "
        "has no cluster/storage_rest.py yet) and names what is missing",
}


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant) and isinstance(
                    body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


class _AiohttpToFront(ast.NodeTransformer):
    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module == "aiohttp" and [a.name for a in node.names] == ["web"]:
            return ast.ImportFrom(module=None, names=node.names, level=1)
        if node.level == 0 and node.module and node.module.split(".")[0] == "minio_tpu":
            node.module = "minio_tpu_torch" + node.module[len("minio_tpu"):]
        return node


def _definitions(path: str, reference: bool) -> dict[str, str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    if reference:
        tree = _AiohttpToFront().visit(tree)
    tree = _strip_docstrings(tree)
    out: dict[str, str] = {}
    rest = []

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[prefix + node.name] = ast.dump(node)
            elif isinstance(node, ast.ClassDef):
                members = [n for n in node.body
                           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
                shell = ast.ClassDef(
                    name=node.name, bases=node.bases, keywords=node.keywords,
                    body=[n for n in node.body if n not in members],
                    decorator_list=node.decorator_list, type_params=[],
                )
                out[prefix + node.name] = ast.dump(shell)
                walk(members, prefix + node.name + ".")
            elif not prefix:
                rest.append(ast.dump(node))

    walk(tree.body, "")
    out["<module>"] = "\n".join(rest)
    return out


@pytest.mark.parametrize("mod", COPIED)
def test_port_module_is_a_copy_of_the_reference(mod):
    ref = _definitions(os.path.join(ROOT, "minio_tpu", mod), reference=True)
    port = _definitions(os.path.join(ROOT, "minio_tpu_torch", mod), reference=False)
    differ = {name for name in ref.keys() | port.keys() if ref.get(name) != port.get(name)}
    allowed = {name for (m, name) in DELIBERATE if m == mod}
    assert differ == allowed, (
        f"{mod}: unexpected differences {sorted(differ - allowed)}, "
        f"listed but equal {sorted(allowed - differ)}"
    )


def test_every_deliberate_difference_names_a_copied_module():
    assert {m for m, _ in DELIBERATE} <= set(COPIED)
    assert all(len(why) > 20 for why in DELIBERATE.values())

