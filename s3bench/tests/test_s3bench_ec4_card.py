"""One traced run of ``ec4.put-1mib`` on the card, through the benchmark's
own command: MinIO's default 16-drive set at EC:4 (12+4), whose PUT
blocks go through the bit-plane product and K2. Marked ``cuda``; skips
without a card. On the card:
``python3 -m pytest -p no:cacheprovider s3bench/tests/test_s3bench_ec4_card.py``."""

import json
import os
import subprocess
import sys
import time
import uuid

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_s3bench_reaper import wait_gone  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on the card")


def test_ec4_put_cell_traced_on_the_card(card):
    marker = f"s3bench-{uuid.uuid4()}"
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "s3bench/run.py", "--workload", "ec4.put-1mib", "--seed",
         str(2 ** 31 + 4343), "--seconds", "10", "--trace", "1"],
        cwd=ROOT, env={**os.environ, "S3BENCH_TEST_MARKER": marker},
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks["k2_launches"] >= 1
    assert checks["dispatch_numpy_blocks"] == 0 and checks["dispatch_demotions"] == 0
    assert checks["shard_wrong"] == 0 and checks["objects_sampled"] >= 1
    # read back with 4 of the 16 drives lost, then with all of them
    assert checks["get_wrong_p_lost"] == 0 and checks["get_wrong"] == 0
    metrics = line["metrics"]
    for m in ("put_encode_roofline_pct", "k2_hash_roofline_pct"):
        assert 0 < metrics[m]["value"] < 100, m
    for m in ("device_idle_pct.put", "idle_upstream_pct.put", "idle_dispatcher_pct.put"):
        assert 0 <= metrics[m]["value"] <= 100, m
    assert "k1_encode_roofline_pct" not in metrics
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert wait_gone(marker, 10) == []
    assert time.monotonic() - t0 < 1200
