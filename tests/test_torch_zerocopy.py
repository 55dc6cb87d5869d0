"""The reference's ``tests/test_zerocopy.py``, run as written against the
port (``tests/test_torch_suites.py``)."""

import os

import numpy as np

from tests.test_torch_suites import check_replaced, load_port_suite

REPLACED: dict[str, str] = {
    "test_pallas_interpret_encode_from_arena_view":
        "runs the reference's Pallas kernel through minio_tpu.ops.rs_jax / rs_pallas, which "
        "have no counterpart in the port; the port's case feeds the same arena view to the "
        "torch codec's encode and to K3's wrapper on the codec's device",
    "test_dispatcher_exact_fit_arena_direct":
        "the reference's body sets MINIO_TPU_BACKEND=jax, which on the CPU keeps the port's "
        "writes off its dispatcher (the port's CPU route is MINIO_TPU_BACKEND=torch); the "
        "port's case PUTs through each package's device route in a process of its own and "
        "holds the port's counts to the reference's",
}

load_port_suite("test_zerocopy", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


def test_pallas_interpret_encode_from_arena_view():
    """An arena-backed [B, d, n] view is a bit-exact input of the port's
    device encode: the torch codec and K3's wrapper, each given the view
    as the codec's device holds it, give the GF reference's parity. On the
    CPU the codec takes the view without a copy; on a card it is copied
    there once, and K3 runs on the card."""
    from minio_tpu_torch.erasure import bufpool
    from minio_tpu_torch.ops import gf, rs, rs_cuda, rs_torch

    d, p, n = 4, 2, 1024
    codec = rs.get_codec(d, p)
    tc = rs_torch.get_torch_codec(d, p)
    pool = bufpool.BufferPool()
    lease = pool.acquire(2 * d * n)
    try:
        arena = lease.array[: 2 * d * n].reshape(2, d, n)
        arena[:] = RNG.integers(0, 256, size=(2, d, n), dtype=np.uint8)  # noqa: F821
        view = tc.as_tensor(arena)
        if view.device.type == "cpu":
            assert view.data_ptr() == arena.ctypes.data  # no copy on the way in
        outs = (tc.encode_blocks(arena), rs_cuda.gf_apply_cuda(tc.w_encode, view, p))
        for out in outs:
            assert out.device == view.device
            for b in range(2):
                np.testing.assert_array_equal(
                    out[b].cpu().numpy(), gf.gf_matvec_blocks(codec.parity_matrix, arena[b]))
    finally:
        lease.release()


_EXACT_FIT = """
import importlib, json, sys, tempfile
import numpy as np
pkg, drives, batch_mb, batches = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
bufpool = importlib.import_module(pkg + ".erasure.bufpool")
aggregate_stats = importlib.import_module(pkg + ".parallel.dispatcher").aggregate_stats
ErasureSet = importlib.import_module(pkg + ".erasure.set").ErasureSet
XLStorage = importlib.import_module(pkg + ".storage.xlstorage").XLStorage
data = np.random.default_rng(batch_mb).integers(0, 256, size=batches * batch_mb << 20,
                                                dtype=np.uint8).tobytes()
root = tempfile.mkdtemp(dir=sys.argv[5])
es = ErasureSet([XLStorage(f"{root}/d{i}") for i in range(drives)])
es.make_bucket("zc")
before = aggregate_stats()
bufpool.copies_reset()
es.put_object("zc", "obj", (data[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20)))
after = aggregate_stats()
copies = bufpool.copies_snapshot()
_, it = es.get_object("zc", "obj")
assert b"".join(bytes(c) for c in it) == data
print(json.dumps({"moved": [after.get(k, 0) - before.get(k, 0)
                            for k in ("arena_direct", "pad_blocks")], "copies": copies}))
"""


def _exact_fit(tmp_path, pkg: str, drives: int, batch_mb: int, batches: int) -> tuple:
    """``batches`` streaming batches of batch_mb 1 MiB blocks PUT through
    ``pkg``'s erasure set on its device route, in a process of its own
    (the reference's object layer imports its cluster plane): (arena_direct,
    pad_blocks) moved, and the copy counters; the bytes read back."""
    import json
    import subprocess
    import sys

    env = dict(os.environ, MINIO_TPU_NATIVE_PLANE="0", MINIO_TPU_ZEROCOPY="1",
               MINIO_TPU_STREAM_BATCH_MB=str(batch_mb), JAX_PLATFORMS="cpu",
               MINIO_TPU_BACKEND="torch" if pkg == "minio_tpu_torch" else "jax")
    proc = subprocess.run([sys.executable, "-c", _EXACT_FIT, pkg, str(drives), str(batch_mb),
                           str(batches), str(tmp_path)], env=env, capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return tuple(out["moved"]), out["copies"]


def test_dispatcher_exact_fit_arena_direct(tmp_path):
    """A streaming batch goes to the device as the caller's array, with no
    pad block, in both packages, with the reference's copy counts: 4
    blocks at EC 2+2 (no staging or assembly copy) and 16 blocks over 16
    drives at their default parity, EC 12+4 (a 16 MiB batch)."""
    ref, ref_copies = _exact_fit(tmp_path, "minio_tpu", 4, 4, 1)
    port, copies = _exact_fit(tmp_path, "minio_tpu_torch", 4, 4, 1)
    assert ref == port == (1, 0), (ref, port)
    assert copies == ref_copies, (ref_copies, copies)
    assert copies["staging"] == copies["dispatch-concat"] == copies["dispatch-pad"] == 0, copies

    ref, ref_copies = _exact_fit(tmp_path, "minio_tpu", 16, 16, 1)
    port, copies = _exact_fit(tmp_path, "minio_tpu_torch", 16, 16, 1)
    assert ref == port == (1, 0), (ref, port)
    assert copies == ref_copies, (ref_copies, copies)
