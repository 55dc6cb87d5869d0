"""Device-plane rules: ``hostsync`` and ``gf-dtype``.

``hostsync`` guards the fused-encode throughput: a host↔device sync
inside the dispatch path serializes the card behind the Python thread,
so materialization (np.asarray / float() / .item() / .cpu() / .numpy()
/ .tolist() / torch.cuda.synchronize() / to_numpy()) is only allowed at
the whitelisted batch-boundary points where results fan back to request
threads, or at host-side table construction that never touches device
tensors.

``gf-dtype`` pins the GF(2^8) byte domain: lookup tables and stripe
buffers must be explicit uint8 (a defaulted float allocation silently
4-8x-es HBM traffic and breaks XOR identities), numpy and torch
allocations alike; Pallas block shapes (the reference package's
kernels) must sit on the (8, 128) float32/int8 TPU tile.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Iterator

from .core import Finding, FunctionStackVisitor, dotted_name, rule

# files whose function bodies count as device hot path: the torch rungs
# and the hand kernels' wrappers. ops/cauchy.py is deliberately NOT
# here: its CauchyPiggyback class is the host-side numpy REFERENCE codec
# (like ops/rs.py), and its device entry points (encode_blocks /
# encode_and_hash_cauchy) hold no syncs — it sits under the
# gf-dtype/tiling gate below instead ("ops/*.py").
_HOT_PATH_GLOBS = (
    "parallel/dispatcher.py",
    "ops/*_torch.py",
    "ops/*_cuda.py",
)

# (relpath, function name) pairs where host materialization is the
# point — batch boundaries where device results fan back to request
# threads, and trace-time weight construction that runs on host numpy
# before anything is device-resident. Everything else needs a pragma
# with a reason.
HOSTSYNC_BOUNDARY: dict[str, set[str]] = {
    # batch fan-out: futures hand numpy shards back to request threads;
    # the degradation probe's materialization IS the probe verdict
    # (_dispatch_group is the per-family half of the old _loop body)
    "parallel/dispatcher.py": {
        "_loop", "_dispatch_group", "_fused_cm", "_probe_device",
    },
    # decode boundary: rebuilt shards + digests materialize for the
    # bitrot/write plane; to_numpy is the device-to-host copy the batch
    # boundaries call (itself a named sync below)
    "ops/bitrot_torch.py": {"_try_fused_decode", "to_numpy"},
    # host-side GF weight construction (cached per shape) and the
    # bytes-in/bytes-out API boundary: as_tensor takes host bytes onto
    # the device (its numpy calls see host arrays only: tensors return
    # first), codec_from_matrices checks numpy matrices at construction
    "ops/rs_torch.py": {
        "gf_matrix_to_bitplanes", "encode_data", "as_tensor",
        "codec_from_matrices",
    },
    # the hand kernels' lookup tables, built on the host from numpy GF
    # matrices before anything is on the device (cached per matrix)
    "ops/fused_cuda.py": {"gf_tables"},
    "ops/gf_cuda.py": {"wide_tables"},
    "ops/rs_cuda.py": {"_as_bits"},
}

_SYNC_ATTRS = {"block_until_ready", "item", "cpu", "numpy", "tolist",
               "synchronize"}
_SYNC_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "jax.device_get", "torch.cuda.synchronize", "to_numpy",
}


def _in_hot_path(relpath: str) -> bool:
    return any(fnmatch.fnmatch(relpath, g) for g in _HOT_PATH_GLOBS)


@rule("hostsync")
def check_hostsync(tree: ast.AST, ctx) -> Iterator[Finding]:
    if not _in_hot_path(ctx.relpath):
        return []
    boundary = HOSTSYNC_BOUNDARY.get(ctx.relpath, set())
    findings: list[Finding] = []

    class V(FunctionStackVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            fn = self.current_function
            # module scope (import-time table building) and boundary
            # functions are exempt
            if fn is not None and fn.name not in boundary:
                label = None
                name = dotted_name(node.func)
                if name in _SYNC_CALLS:
                    label = f"`{name}`"
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_ATTRS
                ):
                    label = f"`.{node.func.attr}()`"
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int")
                    and node.args
                    and isinstance(
                        node.args[0],
                        (ast.Name, ast.Attribute, ast.Subscript),
                    )
                ):
                    # float(x)/int(x) on a bare name forces a device
                    # sync when x is a jax scalar; literals and call
                    # results (env reads etc.) stay exempt
                    label = f"`{node.func.id}()` on a device value"
                if label is not None:
                    findings.append(
                        Finding(
                            ctx.path, node.lineno, "hostsync",
                            f"{label} in device hot path `{fn.name}` forces a "
                            "host sync; keep data device-resident or move "
                            "the materialization to a whitelisted batch "
                            "boundary",
                        )
                    )
            self.generic_visit(node)

    V().visit(tree)
    return findings


# -- gf-dtype / tiling -----------------------------------------------------

# allocations bound to these names must carry an explicit uint8 dtype:
# they hold GF(2^8) bytes (tables, stripe/shard/parity buffers, hash
# packets). Bit-plane weight matrices (int8 into the MXU) and log tables
# (signed arithmetic) intentionally do not match.
_GF_NAME_RE = re.compile(
    r"(?i)(gf_?table|mul_table|inv_table|exp_table|stripe|shards?$|"
    r"parity|packet|blocks?$|surv|cauchy|sub_?chunks?|piggyback|rebuilt)"
)
_ALLOC_FNS = {
    "np.zeros", "np.empty", "np.full", "np.ones",
    "jnp.zeros", "jnp.empty", "jnp.full", "jnp.ones",
    "numpy.zeros", "numpy.empty", "numpy.full", "numpy.ones",
    "torch.zeros", "torch.empty", "torch.full", "torch.ones",
}
_GF_FILE_GLOBS = ("ops/*.py", "erasure/coder.py", "parallel/dispatcher.py")
_UINT8_NAMES = {"uint8", "np.uint8", "jnp.uint8", "numpy.uint8", "torch.uint8"}


def _dtype_of(call: ast.Call) -> str | None:
    """'uint8'-style dotted name (or literal) of the dtype argument."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _dtype_name(kw.value)
    # positional dtype: zeros(shape, dtype) / full(shape, fill, dtype);
    # torch takes the dtype by keyword only (positionals are sizes)
    fname = dotted_name(call.func) or ""
    if fname.startswith("torch."):
        return None
    pos = 2 if fname.endswith("full") else 1
    if len(call.args) > pos:
        return _dtype_name(call.args[pos])
    return None


def _dtype_name(node: ast.AST) -> str:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return dotted_name(node) or "<expr>"


def _assigned_names(parents: list[ast.AST]) -> list[str]:
    """Names the nearest enclosing Assign/AnnAssign binds."""
    for p in reversed(parents):
        if isinstance(p, ast.Assign):
            out = []
            for t in p.targets:
                if isinstance(t, ast.Name):
                    out.append(t.id)
                elif isinstance(t, ast.Attribute):
                    out.append(t.attr)
            return out
        if isinstance(p, ast.AnnAssign) and isinstance(p.target, ast.Name):
            return [p.target.id]
    return []


@rule("gf-dtype")
def check_gf_dtype(tree: ast.AST, ctx) -> Iterator[Finding]:
    if not any(fnmatch.fnmatch(ctx.relpath, g) for g in _GF_FILE_GLOBS):
        return []
    findings: list[Finding] = []

    parents: list[ast.AST] = []

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            _check_alloc(node)
            _check_blockspec(node)
        parents.append(node)
        for child in ast.iter_child_nodes(node):
            walk(child)
        parents.pop()

    def _check_alloc(call: ast.Call) -> None:
        if (dotted_name(call.func) or "") not in _ALLOC_FNS:
            return
        names = _assigned_names(parents)
        if not any(_GF_NAME_RE.search(n) for n in names):
            return
        dtype = _dtype_of(call)
        if dtype is None:
            findings.append(
                Finding(
                    ctx.path, call.lineno, "gf-dtype",
                    f"GF buffer `{'/'.join(names)}` allocated without an "
                    "explicit dtype (defaults to float64: 8x HBM traffic, "
                    "broken XOR identities); use dtype=np.uint8 "
                    "(torch.uint8 for a tensor)",
                )
            )
        elif dtype not in _UINT8_NAMES:
            findings.append(
                Finding(
                    ctx.path, call.lineno, "gf-dtype",
                    f"GF buffer `{'/'.join(names)}` has dtype {dtype}; "
                    "GF(2^8) tables and stripe buffers must be uint8",
                )
            )

    def _check_blockspec(call: ast.Call) -> None:
        name = dotted_name(call.func) or ""
        if name.split(".")[-1] != "BlockSpec" or not call.args:
            return
        shape = call.args[0]
        if not isinstance(shape, ast.Tuple) or len(shape.elts) < 2:
            return
        # only literal dims are statically checkable; symbolic dims are
        # the kernel author's problem (and covered by runtime tests)
        sublane, lane = shape.elts[-2], shape.elts[-1]
        if isinstance(lane, ast.Constant) and isinstance(lane.value, int):
            if lane.value % 128 != 0:
                findings.append(
                    Finding(
                        ctx.path, call.lineno, "gf-dtype",
                        f"Pallas BlockSpec lane dim {lane.value} is not a "
                        "multiple of 128 (TPU tile is (8, 128)); the "
                        "mosaic lowering will pad or reject it",
                    )
                )
        if isinstance(sublane, ast.Constant) and isinstance(sublane.value, int):
            if sublane.value % 8 != 0 and sublane.value != 1:
                findings.append(
                    Finding(
                        ctx.path, call.lineno, "gf-dtype",
                        f"Pallas BlockSpec sublane dim {sublane.value} is "
                        "not a multiple of 8 (TPU tile is (8, 128))",
                    )
                )

    walk(tree)
    return findings
