"""``chip_smoke.py``'s suite phase (phase 10) rehearsed on the CPU rung.

The phase runs the cases of ``chip_smoke.SUITE_CASES`` through pytest on
the card's route and fails a case that launches no kernel. On the CPU a
wrapper runs its kernel's plain version and counts no launch, so this
script wraps the four wrappers (``fused_cuda.fused_encode_hash`` /
``fused_decode_hash``, ``bitrot_cuda.hash256_blocks``,
``rs_cuda.gf_apply_cuda``) to count each call on a CPU tensor as the
launch the card would make, under the shape key the wrapper gives it,
sets the rung's device to ``cpu`` and calls ``chip_smoke.suite_phase``:
every check of the phase runs as on the card. By default it runs the
entries after ``test_torch_card.py``: that file's cases skip without a
card (a skip fails the phase), and the coherence case before it runs its
suite's numpy host plane on the CPU (``suite_backend``), where it
launches nothing.

Run it from the repository root (the default 48 cases take ~9 minutes
in one process here)::

    python tests/torch_suite_rehearsal.py
    python tests/torch_suite_rehearsal.py test_torch_erasure_set.py::test_range_reads ...

Each case prints its seconds and launches by shape; the last line is one
JSON object with the phase's launches, the ladder's counters and the
dispatchers' counters. A shorter list of cases still meets the phase's
checks over the whole phase: it must launch all four kernels and hold
the ladder case.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_cpu_calls(fc, bc, k3) -> None:
    """Make each wrapper add a launch, by its own shape key, for a call
    on a CPU tensor (where it runs the plain version)."""

    def wrap(mod, name, key):
        inner = getattr(mod, name)

        def counted(*a, **kw):
            out = inner(*a, **kw)
            k = key(*a, **kw)
            if k is not None:
                if mod is fc:
                    attr = "encode_launches" if k[0] == "encode" else "decode_launches"
                    setattr(mod, attr, getattr(mod, attr) + 1)
                else:
                    mod.launches += 1
                mod.launch_shapes[k] += 1
            return out

        setattr(mod, name, counted)

    def cpu(x):
        return x.device.type == "cpu"

    wrap(fc, "fused_encode_hash", lambda x, d, p, *a, **kw:
         ("encode", x.shape[0], d, p, x.shape[2]) if cpu(x) else None)
    wrap(fc, "fused_decode_hash", lambda x, d, p, present, missing, *a, **kw:
         ("decode", x.shape[0], d, p, x.shape[2], tuple(present), tuple(missing))
         if cpu(x) else None)
    wrap(bc, "hash256_blocks", lambda x, *a, **kw: tuple(x.shape) if cpu(x) and len(x) else None)

    wrap(k3, "gf_apply_cuda", lambda w, x, rows, sub=1, **kw:
         (x.shape[0], np.shape(w)[1] // 8, np.shape(w)[0] // 8, x.shape[2] // sub, sub)
         if cpu(x) else None)


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from minio_tpu_torch.ops import bitrot_cuda, fused_cuda, rs_cuda

    count_cpu_calls(fused_cuda, bitrot_cuda, rs_cuda)
    cs.CARD_RUNG = dict(cs.CARD_RUNG, MINIO_TPU_TORCH_DEVICE="cpu")
    cs.SUITE_CASES = tuple(argv) or cs.SUITE_CASES[cs.SUITE_CASES.index("test_torch_card.py") + 1:]
    root = tempfile.mkdtemp(prefix="suite_rehearsal_")
    try:
        res = cs.suite_phase(torch, {"fc": fused_cuda, "bc": bitrot_cuda, "k3": rs_cuda}, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({k: res[k] for k in ("launches", "ladder", "stats", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
