"""The per-file rules of the port's miniovet: the JAX package's fixture
cases (``tests/test_analysis_rules.py``), each through both analyzers
(``test_torch_analysis.Both``), then the torch cases of ``hostsync`` and
``gf-dtype`` and ``knob-native`` on CUDA sources."""

import os
import textwrap

import pytest

from minio_tpu_torch.analysis import analyze_source as port_analyze_source
from minio_tpu_torch.analysis.rules_native import scan_native_source as port_scan_native
from tests.test_torch_analysis import PKG_DIR, check_replaced, load_reference_tests

REPLACED = {
    "test_gf_dtype_covers_cauchy_module":
        "its last step analyses the real ops/cauchy.py of each package; the "
        "port's module is not the reference's text, so each package's file "
        "goes through its own analyzer",
}
BOTH = load_reference_tests("test_analysis_rules", globals(), REPLACED)


def test_gf_dtype_covers_cauchy_module():
    bad_alloc = """
        import numpy as np

        def make(d, p, n):
            cauchy_matrix = np.zeros((p, d))
            sub_chunk = np.zeros(n)
            piggyback = np.empty((p, n))
            rebuilt = np.zeros(n, dtype=np.float64)
            return cauchy_matrix, sub_chunk, piggyback, rebuilt
    """
    fs = run(bad_alloc, relpath="ops/cauchy.py", rules=["gf-dtype"])
    assert len(fs) == 4, [f.message for f in fs]
    # the REAL module of each package passes its own gate
    from minio_tpu.analysis import analyze_source as ref_analyze_source

    for pkg, analyze in (("minio_tpu", ref_analyze_source), ("minio_tpu_torch", port_analyze_source)):
        path = os.path.join(os.path.dirname(PKG_DIR), pkg, "ops", "cauchy.py")
        assert analyze(open(path).read(), path=path, relpath="ops/cauchy.py",
                       rules=["gf-dtype"]) == []


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


# -- torch cases ---------------------------------------------------------------


def _port(src, relpath, rules):
    return port_analyze_source(textwrap.dedent(src), path=relpath, rules=rules, relpath=relpath)


SYNCS = [
    ("t.cpu()", "`.cpu()`"),
    ("t.numpy()", "`.numpy()`"),
    ("t.tolist()", "`.tolist()`"),
    ("t.item()", "`.item()`"),
    ("torch.cuda.synchronize()", "`torch.cuda.synchronize`"),
    ("stream.synchronize()", "`.synchronize()`"),
    ("to_numpy(t)", "`to_numpy`"),
]
HOT = ["ops/rs_torch.py", "ops/bitrot_torch.py", "ops/fused_cuda.py", "ops/rs_cuda.py",
       "parallel/dispatcher.py"]


@pytest.mark.parametrize("expr,label", SYNCS, ids=[s[0] for s in SYNCS])
@pytest.mark.parametrize("relpath", HOT)
def test_hostsync_flags_torch_syncs_in_the_hot_path(expr, label, relpath):
    src = f"""
        import torch

        def encode_step(t, stream):
            return {expr}
    """
    fs = _port(src, relpath, ["hostsync"])
    assert [(f.line, f.rule) for f in fs] == [(5, "hostsync")], fs
    assert fs[0].message.startswith(f"{label} in device hot path `encode_step`")


@pytest.mark.parametrize("expr", [s[0] for s in SYNCS])
def test_hostsync_ignores_torch_syncs_off_the_hot_path(expr):
    src = f"""
        def serve(t, stream):
            return {expr}
    """
    for relpath in ("erasure/coder.py", "ops/cauchy.py", "server/app.py"):
        assert _port(src, relpath, ["hostsync"]) == []


@pytest.mark.parametrize("relpath,fn", [
    ("parallel/dispatcher.py", "_dispatch_group"),
    ("parallel/dispatcher.py", "_fused_cm"),
    ("ops/bitrot_torch.py", "_try_fused_decode"),
    ("ops/bitrot_torch.py", "to_numpy"),
    ("ops/rs_torch.py", "encode_data"),
    ("ops/fused_cuda.py", "gf_tables"),
])
def test_hostsync_boundaries_take_torch_syncs(relpath, fn):
    src = f"""
        import torch

        def {fn}(t):
            torch.cuda.synchronize()
            return t.cpu().numpy()
    """
    assert _port(src, relpath, ["hostsync"]) == []


def test_hostsync_boundary_of_one_file_is_not_another_files():
    src = """
        def to_numpy(t):
            return t.cpu().numpy()
    """
    assert len(_port(src, "ops/rs_cuda.py", ["hostsync"])) == 2


TORCH_ALLOCS = ["torch.zeros", "torch.empty", "torch.ones"]


@pytest.mark.parametrize("alloc", TORCH_ALLOCS)
def test_gf_dtype_flags_torch_stripe_buffer_without_uint8(alloc):
    src = f"""
        import torch

        def make(n):
            stripe = {alloc}((16, n))
            return stripe
    """
    fs = _port(src, "ops/rs_torch.py", ["gf-dtype"])
    assert len(fs) == 1 and "without an explicit dtype" in fs[0].message
    assert "torch.uint8" in fs[0].message


def test_gf_dtype_torch_positional_sizes_are_not_a_dtype():
    # torch.zeros(16, n): both positionals are sizes
    src = """
        import torch

        def make(n):
            parity = torch.zeros(16, n)
            return parity
    """
    fs = _port(src, "ops/bitrot_torch.py", ["gf-dtype"])
    assert len(fs) == 1 and "without an explicit dtype" in fs[0].message


def test_gf_dtype_torch_wrong_and_right_dtypes():
    bad = """
        import torch

        def make(n):
            shards = torch.full((16, n), 0, dtype=torch.float32)
            return shards
    """
    fs = _port(bad, "ops/rs_cuda.py", ["gf-dtype"])
    assert len(fs) == 1 and "torch.float32" in fs[0].message
    good = """
        import torch

        def make(n, dev):
            shards = torch.empty((16, n), dtype=torch.uint8, device=dev)
            w = torch.zeros((128, 128), dtype=torch.float32)
            return shards, w
    """
    assert _port(good, "ops/rs_cuda.py", ["gf-dtype"]) == []


def test_knob_native_scans_cuda_sources(tmp_path):
    from minio_tpu_torch.analysis.core import analyze_paths

    kernel = tmp_path / "minio_tpu_torch" / "csrc" / "k.cu"
    kernel.parent.mkdir(parents=True)
    kernel.write_text(
        '#include <cstdlib>\n'
        'static int threads() { return atoi(getenv("MINIO_TPU_KERNEL_THREADS")); }\n'
        'static int ok() { return getenv("MINIO_TPU_NATIVE_THREADS") != 0; }\n'
    )
    header = tmp_path / "minio_tpu_torch" / "csrc" / "k.cuh"
    header.write_text('const char* s = getenv("MINIO_TPU_CUH_KNOB");  '
                      '// miniovet: ignore[knob-native] -- fixture\n')
    fs = analyze_paths([str(tmp_path / "minio_tpu_torch")], rules=["knob-native"])
    assert [(os.path.basename(f.file), f.line, f.rule) for f in fs] == [("k.cu", 2, "knob-native")]
    assert "MINIO_TPU_KERNEL_THREADS" in fs[0].message
    assert "minio_tpu_torch/analysis/knobs.py" in fs[0].message
    assert port_scan_native(kernel.read_text(), str(kernel))[0].line == 2


def test_the_ports_kernels_read_no_undeclared_knob():
    csrc = os.path.join(PKG_DIR, "csrc")
    names = [n for n in os.listdir(csrc) if n.endswith((".cu", ".cuh"))]
    assert len(names) >= 5
    for n in names:
        path = os.path.join(csrc, n)
        assert port_scan_native(open(path).read(), path) == []


def test_fixture_cases_went_through_both_analyzers():
    assert BOTH.calls >= 60
