"""The S3 core's, the cluster plane's, the alternate frontends' (FTP,
SFTP over the SSH transport, the console) and ``analysis/``'s (the static
gate and the runtime sanitizer) modules are copies of the JAX package's,
with their imports pointed at the port: each port module's
syntax tree equals the reference's, definition by definition, once
docstrings are dropped and the two rewrites the copies take are applied
(``from aiohttp import web`` becomes the port's stdlib front, ``from .
import web`` in server/ and ``from ..server import web`` elsewhere; ``import
msgpack`` becomes ``from ..utils import msgpack_lite as msgpack``). The
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
    "cluster/endpoint.py", "cluster/grid.py", "cluster/storage_rest.py",
    "cluster/locks.py", "cluster/bootstrap.py", "crypto/tlsconf.py",
    "diag/__init__.py", "diag/netperf.py", "diag/speedtest.py", "diag/healthinfo.py",
    "server/profiling.py", "server/admin.py", "server/worker.py", "server/__main__.py",
    "server/ssh.py", "server/sftp.py", "server/ftp.py", "server/console.py",
    "erasure/bufpool.py",
] + [f"analysis/{m}.py" for m in (
    "__init__", "__main__", "core", "output", "rules_async", "rules_cache", "rules_copy",
    "rules_errors", "rules_locks", "rules_obs", "rules_retry", "rules_knobs", "rules_native",
    "rules_tpu", "knobs", "interproc", "project", "rules_races", "rules_resources",
    "surface", "rules_surface", "sanitizer",
)]

GATEWAY_PUT = (
    "writes at the STANDARD storage class (S3Server.put_standard_object), as "
    "MinIO's object layer does for every frontend; the reference's gateways "
    "write at the set's default parity (ROADMAP Queue 3)"
)

NAMES_THE_PORT = (
    "names the port: its package (minio_tpu_torch), its CLI (python -m "
    "minio_tpu_torch.analysis) and its generated tables in "
    "minio_tpu_torch/docs/, which the repository's docs/ (the JAX "
    "package's) never hold"
)

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
    ("cluster/locks.py", "LocalLocker.runlock"):
        "keeps a resource's entry while a writer's waiting marker is live; the "
        "reference drops it with the last reader, and a stream of readers "
        "then starves a heal of its write lock (ROADMAP Queue 3; "
        "tests/test_torch_locks.py)",
    ("server/app.py", "main"):
        "resolves the node's device before bootstrap (a host without a "
        "card refuses to start; the pool's supervisor never touches the "
        "device)",
    ("server/app.py", "S3Server._dispatch"):
        "loads a bucket's metadata off the event loop on first use; the "
        "reference reads the store on the loop there, and a cluster whose "
        "nodes all do so at once waits out the grid's timeouts (ROADMAP "
        "Queue 3; tests/test_torch_cluster.py)",
    ("server/app.py", "S3Server.__init__"):
        "builds its TracePubSub with the span ring (span_ring(), "
        "MINIO_TPU_TRACE_RING): closed spans are kept in memory without a "
        "subscriber, for the benchmark's span readers (s3bench/spans.py)",
    ("server/app.py", "S3Server._entry"):
        "writes the request's own s3.request span into the ring (API, "
        "status, bytes); the request context carries its id, so every span "
        "below names it as parent",
    ("server/metrics.py", "TracePubSub.__init__"):
        "takes the optional span ring that keeps closed spans without a "
        "subscriber (a bare TracePubSub() has none)",
    ("server/metrics.py", "span_ring"):
        "the server's span ring from MINIO_TPU_TRACE_RING (default 262,144 "
        "spans, 0 turns it off)",
    ("server/metrics.py", "_g_api_tpu"):
        "adds minio_tpu_kernel_launches_total{kernel=...} and "
        "minio_tpu_kernel_launch_shapes_total{kernel=...,shape=...}: the hand "
        "kernels' launches in all and by shape, which a deployment's nodes "
        "report to prove their traffic ran on the card at shapes the smoke "
        "then holds against the plain versions; and "
        "minio_tpu_hash_core_launches_total{kernel=...,path=...}: K1's and "
        "K2's hash-core launches by read path (aligned or generic); and "
        "minio_tpu_gf_core_launches_total{kernel=...,plan=...}: K1's and "
        "K3's GF-core launches by plan regime (small or wave)",
    ("server/sftp.py", "_SFTPSession._close"):
        GATEWAY_PUT,
    ("server/sftp.py", "_SFTPSession._rename"):
        GATEWAY_PUT,
    ("server/sftp.py", "_SFTPSession._mkdir"):
        GATEWAY_PUT,
    ("server/ftp.py", "FTPGateway._cmd_stor"):
        GATEWAY_PUT,
    ("server/ftp.py", "FTPGateway._cmd_mkd"):
        GATEWAY_PUT,
    ("server/object_handlers.py", "ObjectHandlersMixin.put_standard_object"):
        "the one PUT the FTP and SFTP gateways make: an S3 PUT's parity and "
        "family without an x-amz-storage-class header, MINIO_STORAGE_CLASS_"
        "STANDARD's (ROADMAP Queue 3)",
    ("server/profiling.py", "<module>"):
        "the continuous profiler classifies stacks by the port's paths "
        "(minio_tpu_torch/parallel/, ...)",
    ("server/worker.py", "supervise"):
        "re-executes the port's server (python -m minio_tpu_torch.server)",
    ("analysis/__main__.py", "<module>"):
        "the --gen-* defaults are the port's tables inside the package "
        "(minio_tpu_torch/docs/), found from the module's path, not the "
        "working directory",
    ("analysis/__main__.py", "_doc"):
        "the path of one of those tables",
    ("analysis/__main__.py", "main"):
        NAMES_THE_PORT,
    ("analysis/core.py", "_package_relpath"):
        "relpaths are relative to minio_tpu_torch/",
    ("analysis/project.py", "extract_summary"):
        "resolves absolute imports of minio_tpu_torch.* as the package's own",
    ("analysis/project.py", "default_cache_path"):
        "the summary cache lives inside the port's package, so it never meets "
        "the JAX package's cache at the repository root (each would bust the "
        "other's entries)",
    ("analysis/rules_tpu.py", "<module>"):
        "hostsync's hot path is the torch rungs and the kernel wrappers "
        "(ops/*_torch.py, ops/*_cuda.py); its syncs add .cpu(), .numpy(), "
        ".tolist(), .synchronize(), torch.cuda.synchronize and to_numpy; its "
        "boundaries are the port's (the dispatcher's, the fused decode, the "
        "bytes-in/out boundary and the kernels' host-side tables); gf-dtype "
        "also checks torch.zeros/empty/full/ones for torch.uint8",
    ("analysis/rules_tpu.py", "check_hostsync"):
        "its message says device hot path",
    ("analysis/rules_tpu.py", "_dtype_of"):
        "torch takes a dtype by keyword only: positionals are sizes",
    ("analysis/rules_tpu.py", "check_gf_dtype"):
        "its message names torch.uint8 for a tensor",
    ("analysis/rules_native.py", "<module>"):
        "also scans the CUDA sources (.cu, .cuh) for getenv of a knob",
    ("analysis/rules_native.py", "scan_native_source"):
        NAMES_THE_PORT,
    ("analysis/rules_knobs.py", "check_knobs"):
        NAMES_THE_PORT,
    ("analysis/rules_knobs.py", "dead_knob_findings"):
        NAMES_THE_PORT,
    ("analysis/knobs.py", "<module>"):
        "the registry describes the port's knobs: MINIO_TPU_BACKEND defaults "
        "to torch (the device route) or numpy; MINIO_TPU_TORCH_DEVICE is "
        "declared; MINIO_TPU_PALLAS goes (no source of the port reads it)",
    ("analysis/knobs.py", "generate_config_md"):
        NAMES_THE_PORT,
    ("analysis/interproc.py", "generate_lock_order_md"):
        NAMES_THE_PORT,
    ("analysis/rules_races.py", "generate_concurrency_md"):
        NAMES_THE_PORT,
    ("analysis/rules_resources.py", "generate_resources_md"):
        NAMES_THE_PORT,
    ("analysis/rules_resources.py", "ResourcesEngine._finding"):
        NAMES_THE_PORT,
    ("analysis/rules_surface.py", "generate_surface_md"):
        NAMES_THE_PORT,
    ("analysis/sanitizer.py", "<module>"):
        "captures the raw lock allocators under any other witness's wrapping "
        "factory (the JAX package's sanitizer may be installed in the same "
        "process), keeps the factories install() replaces, matches package "
        "files on the directory and a separator (a sibling minio_tpu_torch_x/ "
        "is not the package), and its leak table names the port's classes",
    ("analysis/sanitizer.py", "_raw_factory"):
        "follows __wrapped__ to the raw allocator",
    ("analysis/sanitizer.py", "_creation_id"):
        "a file of the package is one under its directory and a separator",
    ("analysis/sanitizer.py", "_wrapping_factory"):
        "a lock created outside the package comes from the factory this one "
        "replaced, so another sanitizer's witness keeps its own locks",
    ("analysis/sanitizer.py", "install"):
        "remembers the factories it replaces",
    ("analysis/sanitizer.py", "uninstall"):
        "puts back the factories install() found (never leaves threading "
        "changed), not the raw allocators",
    ("analysis/sanitizer.py", "load_static_order"):
        "reads the port's minio_tpu_torch/docs/LOCK_ORDER.md",
    ("analysis/sanitizer.py", "load_concurrency_table"):
        "reads the port's minio_tpu_torch/docs/CONCURRENCY.md",
    ("analysis/sanitizer.py", "arm_access_witness"):
        "arms classes of minio_tpu_torch.* modules",
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


class _ToPort(ast.NodeTransformer):
    """The reference module's imports as the port writes them."""

    def __init__(self, mod: str):
        self.in_server = mod.startswith("server/")

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module == "aiohttp" and [a.name for a in node.names] == ["web"]:
            if self.in_server:
                return ast.ImportFrom(module=None, names=node.names, level=1)
            return ast.ImportFrom(module="server", names=node.names, level=2)
        if node.level == 0 and node.module and node.module.split(".")[0] == "minio_tpu":
            node.module = "minio_tpu_torch" + node.module[len("minio_tpu"):]
        return node

    def visit_Import(self, node):
        if [(a.name, a.asname) for a in node.names] == [("msgpack", None)]:
            return ast.ImportFrom(module="utils", level=2,
                                  names=[ast.alias(name="msgpack_lite", asname="msgpack")])
        return node


def _definitions(path: str, mod: str, reference: bool) -> dict[str, str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    if reference:
        tree = _ToPort(mod).visit(tree)
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
    ref = _definitions(os.path.join(ROOT, "minio_tpu", mod), mod, reference=True)
    port = _definitions(os.path.join(ROOT, "minio_tpu_torch", mod), mod, reference=False)
    differ = {name for name in ref.keys() | port.keys() if ref.get(name) != port.get(name)}
    allowed = {name for (m, name) in DELIBERATE if m == mod}
    assert differ == allowed, (
        f"{mod}: unexpected differences {sorted(differ - allowed)}, "
        f"listed but equal {sorted(allowed - differ)}"
    )


def test_every_deliberate_difference_names_a_copied_module():
    assert {m for m, _ in DELIBERATE} <= set(COPIED)
    assert all(len(why) > 20 for why in DELIBERATE.values())

