"""Build and load the port's CUDA kernels (``minio_tpu_torch/csrc/*.cu``).

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, into a shared library with a plain C interface under
``minio_tpu_torch/_build/`` (git-ignored), for ``sm_90a``. A library is
rebuilt when it is older than its source or any ``.cuh`` header.
``load()`` returns the loaded ``ctypes`` libraries by source name; a
failed build raises with the compiler's output. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] | None = None
# compiler output of each source built with verbose=True in this process
# (with -Xptxas -v: every kernel's registers, shared memory and spills)
logs: dict[str, str] = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U64 = ctypes.c_uint64

# C signatures: every pointer and the stream are void*, so ctypes never
# truncates them to 32-bit ints
SIGNATURES = {
    "hh_chain": {
        # (msgs, rows, n, pitch, k0..k3, out, aligned, plan: msgs_per_cta,
        #  stages, stage_bytes, slot_bytes, smem_bytes, stream)
        "hh_chain": [_P, _I64, _I64, _I64, _U64, _U64, _U64, _U64, _P, *[_I64] * 6, _P],
        # (dst, dst_pitch, dst_rows, src, src_pitch, src_rows, width, rows,
        #  items, to_device, stream)
        "copy_rows": [_P, _I64, _I64, _P, *[_I64] * 6, _P],
    },
    "gf_apply": {
        # (in, in_bs, out, out_bs, B, k, r, n, tables, offs, GF plan:
        #  threads, grid, row_groups, stream)
        "gf_apply": [_P, _I64, _P, _I64, _I64, _I, _I, _I64, _P, _P, _I64, _I64, _I64, _P],
    },
    "fused_encode_hash": {
        # (data, B, d, p, n, tables, k0..k3, out, digests, GF plan (3),
        #  aligned, hash plan: msgs_per_cta, stages, stage_bytes,
        #  slot_bytes, smem_bytes, stream)
        "fused_encode_hash": [_P, _I64, _I, _I, _I64, _P,
                              _U64, _U64, _U64, _U64, _P, _P, *[_I64] * 9, _P],
        # (data, B, d, p, n, tables, out, GF plan (3), stream): the GF launch alone
        "fused_gf_apply": [_P, _I64, _I, _I, _I64, _P, _P, _I64, _I64, _I64, _P],
    },
}


def nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale(so: str, src: str) -> bool:
    if not os.path.exists(so):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return any(os.path.getmtime(so) < os.path.getmtime(d) for d in deps)


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every stale source, one nvcc each, in parallel. Returns
    {name: library path}; raises RuntimeError naming each failed build."""
    os.makedirs(BUILD, exist_ok=True)
    out: dict[str, str] = {}
    procs = []
    for src in sources():
        name = os.path.splitext(os.path.basename(src))[0]
        so = os.path.join(BUILD, f"lib{name}.so")
        out[name] = so
        if not _stale(so, src):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", CSRC, "-o", tmp, src]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            logs[name] = log
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library once per process."""
    global _libs
    if _libs is not None:
        return _libs
    with _lock:
        if _libs is None:
            libs = {}
            for name, so in build().items():
                lib = ctypes.CDLL(so)
                for fn, argtypes in SIGNATURES.get(name, {}).items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                libs[name] = lib
            _libs = libs
    return _libs


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def key_words(key: bytes) -> list[int]:
    """32-byte HighwayHash key -> its four little-endian 64-bit words."""
    return [int.from_bytes(key[8 * i : 8 * i + 8], "little") for i in range(4)]
