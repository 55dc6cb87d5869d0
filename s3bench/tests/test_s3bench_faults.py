"""The comparison that decides ``correct``, against the control and the
planted faults, on the CPU at a size a test run holds.

Each case drives a whole run (generators, server, window, reference
check) through ``s3bench/run.py --cpu`` on the test cells of
``data/bench.json``: the configurations of BENCHMARK.json on the
program's host route, with small objects and few requests. A sound run
must read ``correct: true``; the control (the configuration's parity
lowered) and each fault that the cell can have must read false.
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BENCH = os.path.join(HERE, "data", "bench.json")
CELLS = ("ec8.put", "ec4.put")
FAULTS = ("control", "state-unchanged", "half-batch", "answer-altered")


def _per_layer(cell: str) -> set:
    """The per-layer metrics a traced CPU run of the cell reads: those
    of the test bench that need no device trace."""
    with open(BENCH) as f:
        return {m["name"] for m in json.load(f)["per_layer"] if cell in m["workloads"]}


def run_cell(cell: str, fault: str = "", seed: int = 2 ** 31 + 99, trace: bool = False) -> dict:
    argv = [sys.executable, os.path.join(ROOT, "s3bench", "run.py"), "--benchmark", BENCH,
            "--cpu", "--workload", cell, "--seed", str(seed), "--seconds", "2",
            "--trace", str(int(trace))]
    if fault:
        argv += ["--fault", fault]
    out = subprocess.run(argv, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check processes_left: 0")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run_cell(cell)
    assert line["correct"] is True, line["checks"]
    traced = run_cell(cell, trace=True)
    assert traced["correct"] is True, traced["checks"]
    assert set(traced["metrics"]) == _per_layer(cell)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    line = run_cell(cell, fault)
    assert line["correct"] is False, line["checks"]
    wrong = {k for k, v in line["checks"].items() if k != "objects_sampled" and v["value"] > 0}
    assert wrong, line["checks"]
