"""Repairs that came with the port's S3 core, each pinned against the
reference or the decision it records:

- ``CauchyTorchCodec.encode_data`` equals ``CauchyTpuCodec.encode_data``
  byte for byte, at even shard sizes (the device encode) and odd ones
  (the numpy codec);
- a host without a card refuses to start the server unless the env asks
  for the CPU or another rung: ``make_server`` raises ``device.resolve``'s
  error, it never carries on silently on the CPU;
- the SSE keys of multipart and the transform test of the cache have one
  definition each (``crypto/sse.py``, ``server/transforms.py``);
- no port file states a TPU-era number or reason.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minio_tpu.ops import cauchy as ref_cauchy
from minio_tpu_torch.ops import cauchy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("d,p,size", [
    (4, 2, 4 * 1000),        # per 1000: even, device encode
    (4, 2, 4 * 1000 - 3),    # even per, padded tail
    (4, 2, 4 * 1001),        # odd per: numpy codec
    (3, 2, 1),               # one byte: per 1
    (8, 8, 8 * 4096),
    (8, 8, 8 * 4097 + 5),    # per 4098: even, padded
    (8, 8, 8 * 4097),        # odd
    (12, 4, 12 * 2 * 700),
])
def test_cauchy_encode_data_matches_reference(d, p, size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    want = ref_cauchy.get_tpu_codec(d, p).encode_data(data)
    got = cauchy.get_torch_codec(d, p).encode_data(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (d + p, want.shape[1])
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, ref_cauchy.get_codec(d, p).encode(ref_cauchy.get_codec(d, p).split(data)))


_CARDLESS = r"""
import sys
from minio_tpu_torch.server.app import make_server
try:
    make_server([sys.argv[1] + "/d%d" % i for i in range(4)])
except RuntimeError as e:
    print("REFUSED", e)
else:
    print("STARTED")
"""


@pytest.mark.parametrize("env,want", [
    ({}, "REFUSED"),
    ({"MINIO_TPU_TORCH_DEVICE": "cpu"}, "STARTED"),
    ({"MINIO_TPU_BACKEND": "numpy"}, "STARTED"),
])
def test_server_without_a_card_refuses_unless_told(tmp_path, env, want):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card-less decision does not apply")
    clean = {k: v for k, v in os.environ.items()
             if k not in ("MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_BACKEND", "PYTHONPATH")}
    clean.update(env, PYTHONPATH=ROOT, MINIO_TPU_SCAN_INTERVAL="0")
    out = subprocess.run([sys.executable, "-c", _CARDLESS, str(tmp_path)],
                         capture_output=True, text=True, env=clean, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == want, out.stdout
    if want == "REFUSED":
        from minio_tpu_torch import device

        with pytest.raises(RuntimeError) as exc:
            device.resolve("cuda")
        assert str(exc.value) in out.stdout


def test_multipart_takes_its_sse_keys_from_the_crypto_layer():
    from minio_tpu.erasure import multipart as ref_mp
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.erasure import multipart

    src = inspect.getsource(multipart)
    for name in ("SSE_META_ALGO", "SSE_META_ACTUAL_SIZE", "SSE_META_PART_SIZES"):
        assert not hasattr(multipart, name), name
        assert name not in src
    assert "from ..crypto import sse as ssemod" in src
    for name in ("META_ALGO", "META_ACTUAL_SIZE", "META_PART_SIZES"):
        assert f"ssemod.{name}" in src
    assert src.count("ssemod.META_") == inspect.getsource(ref_mp).count("ssemod.META_")
    assert sse.META_ALGO == "x-minio-internal-sse"


def test_cache_asks_the_transforms_module():
    from types import SimpleNamespace

    from minio_tpu_torch.cache import core
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.server import transforms

    assert not hasattr(core, "_TRANSFORM_META")
    assert "transforms.is_transformed(fi.metadata)" in inspect.getsource(core._transformed)
    for meta, want in (({}, False), ({sse.META_ALGO: "SSE-S3"}, True),
                       ({transforms.META_COMPRESSION: "klauspost/compress/s2"}, True),
                       ({"x-amz-meta-a": "1"}, False)):
        assert core._transformed(SimpleNamespace(metadata=meta)) is want
        assert transforms.is_transformed(meta) is want
    assert core._transformed(SimpleNamespace(metadata=None)) is True  # fail-safe


@pytest.mark.parametrize("needle", ["41.76", "GiB/s fused", "tunnel", "TPU v5e"])
def test_no_tpu_era_number_or_reason_in_the_port(needle):
    hits = []
    for dp, _, fs in os.walk(os.path.join(ROOT, "minio_tpu_torch")):
        for f in fs:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                path = os.path.join(dp, f)
                if needle in open(path, encoding="utf-8").read():
                    hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits
