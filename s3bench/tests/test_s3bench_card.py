"""One cell on the card: ``ec8.put-1mib`` for 10 s through the
benchmark's own command. Marked ``cuda``; skips without a card. On the
card: ``python3 -m pytest -p no:cacheprovider s3bench/tests/test_s3bench_card.py``."""

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


def test_put_cell_on_the_card(card):
    marker = f"s3bench-{uuid.uuid4()}"
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "s3bench/run.py", "--workload", "ec8.put-1mib", "--seed",
         str(2 ** 31 + 4242), "--seconds", "10", "--trace", "0"],
        cwd=ROOT, env={**os.environ, "S3BENCH_TEST_MARKER": marker},
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"card_ms_per_gib.put", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert wait_gone(marker, 10) == []
    assert time.monotonic() - t0 < 1200
