"""The port's graft entry (minio_tpu_torch/graft_entry.py) against the
repository's ``__graft_entry__.py``, on the CPU: the one-step check is
byte-identical to the reference's jitted step, the multi-device dry run
passes on 8 gloo ranks, and a rank that fails fails the call."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from minio_tpu_torch import graft_entry as ge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_LIMIT_S = 300  # the spawned ranks' own limit here (the module's: 900 s)


def test_entry_matches_the_reference_step():
    import jax

    sys.path.insert(0, ROOT)
    import __graft_entry__ as ref

    fn, args = ge.entry(device="cpu")
    parity, digests = fn(*args)
    assert tuple(parity.shape) == (2, 2, 1024) and tuple(digests.shape) == (2, 6, 32)
    rfn, rargs = ref.entry()
    np.testing.assert_array_equal(args[0], rargs[0])
    rparity, rdigests = jax.jit(rfn)(*rargs)
    np.testing.assert_array_equal(parity.numpy(), np.asarray(rparity))
    np.testing.assert_array_equal(digests.numpy(), np.asarray(rdigests))


def test_entry_takes_the_device_from_the_environment(monkeypatch):
    import torch

    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    fn, args = ge.entry()
    parity, _ = fn(*args)
    assert parity.device == torch.device("cpu")
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ge.entry()


def test_dryrun_multichip_8(capsys):
    res = ge.dryrun_multichip(8, device="cpu", timeout_s=DRYRUN_LIMIT_S)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 8 devices (gloo), EC 8+8, 8 x 1 MiB blocks, " \
           "3 erasure patterns, parity (8, 8, 131072), digests (8, 16, 32)" in out
    assert res["backend"] == "gloo" and res["world"] == 8
    assert res["launches"] == {}  # K2's wrapper counts launches on the card only


def test_dryrun_shape_and_patterns_are_the_references():
    """EC 8+8, 1 MiB blocks, seed 0 and the three erasure patterns, as
    ``__graft_entry__._dryrun_impl`` assigns them."""
    import ast

    src = open(os.path.join(ROOT, "__graft_entry__.py"), encoding="utf-8").read()
    impl = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "_dryrun_impl")
    env: dict = {}
    for node in impl.body:
        names = {n.id for n in ast.walk(node.targets[0])
                 if isinstance(n, ast.Name)} if isinstance(node, ast.Assign) else set()
        if names & {"d", "p", "n", "patterns"}:
            exec(ast.unparse(node), env)
    assert (env["d"], env["p"], env["n"]) == (ge.D, ge.P, ge.N)
    assert env["patterns"] == ge.PATTERNS
    assert "default_rng(0)" in src and ge.SEED == 0


def _failing_rank(rank, world, kind, init_method, results):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    ge._rank(rank, world, kind, init_method, results)


def test_a_failing_rank_fails_the_call(capsys):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        ge._launch(2, "cpu", target=_failing_rank, timeout_s=DRYRUN_LIMIT_S)
    assert "OK" not in capsys.readouterr().out


def _stuck_rank(rank, world, kind, init_method, results):
    import time

    time.sleep(600)


def test_a_rank_past_the_limit_fails_the_call():
    with pytest.raises(RuntimeError, match="timed out"):
        ge._launch(1, "cpu", target=_stuck_rank, timeout_s=5)


def test_module_runs_as_a_program(tmp_path):
    import subprocess

    env = dict(os.environ, MINIO_TPU_TORCH_DEVICE="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "minio_tpu_torch.graft_entry", "2"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=DRYRUN_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK: 2 devices (gloo)" in proc.stdout


def test_main_defaults_to_every_card(monkeypatch):
    """With no argument the dry run takes one rank a visible card, and the
    reference's 8 where the CPU is asked for or no card is visible."""
    import torch

    asked = []
    monkeypatch.setattr(ge, "dryrun_multichip", asked.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("MINIO_TPU_TORCH_DEVICE", raising=False)
    assert ge.main([]) == 0 and asked == [1]
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    assert ge.main([]) == 0 and asked == [1, 8]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MINIO_TPU_TORCH_DEVICE")
    assert ge.main([]) == 0 and ge.main(["3"]) == 0 and asked == [1, 8, 8, 3]
