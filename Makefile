# Developer entry points. `make check` is the static gate every PR must
# pass (tier-1 enforces the same thing via tests/test_analysis.py).

PY ?= python

.PHONY: check check-clean test docs bench-smoke diag-smoke diag-smoke-torch

# whole-program static analysis (per-file rules + interprocedural
# passes) with the content-hash incremental cache: warm runs re-parse
# only changed files (timings on stderr). `make check-clean` busts it.
check:
	$(PY) -m minio_tpu.analysis minio_tpu/ --strict --cache --jobs 2

check-clean:
	$(PY) -m minio_tpu.analysis --clean-cache
	$(PY) -m minio_tpu.analysis minio_tpu/ --strict --cache --jobs 2

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m 'not slow' \
		--continue-on-collection-errors -p no:cacheprovider

docs:
	$(PY) -m minio_tpu.analysis --gen-config-docs docs/CONFIG.md
	$(PY) -m minio_tpu.analysis minio_tpu/ --cache --gen-lock-order docs/LOCK_ORDER.md
	$(PY) -m minio_tpu.analysis minio_tpu/ --cache --gen-concurrency docs/CONCURRENCY.md
	$(PY) -m minio_tpu.analysis minio_tpu/ --cache --gen-resources docs/RESOURCES.md
	$(PY) -m minio_tpu.analysis minio_tpu/ --cache --gen-surface docs/SURFACE.md

# harness-stays-runnable gate: the closed-loop load harness end to end
# (worker pool, mixed zipf traffic, heal flood, QoS guard metrics) in
# seconds — full runs write BENCH json, this just proves it still works.
# Then every named workload profile at toy scale, each with its real
# gates armed (a missing gate series fails the run, never passes it) —
# --all includes repair-degraded-storm, the seeded drive-failure +
# straggler storm with verifying traffic and the windowed-vs-serial
# repair A/B.
bench-smoke:
	MINIO_TPU_BACKEND=numpy $(PY) benchmarks/bench_load.py --quick
	MINIO_TPU_BACKEND=numpy $(PY) -m benchmarks.scenarios --all --quick

# self-measurement plane end to end vs a live 2-worker pool: quick
# object/drive/net speedtests + healthinfo (json & zip) with zero
# request errors, and every /api/diag series the static surface
# manifest declares present in the live scrape.
diag-smoke:
	MINIO_TPU_BACKEND=numpy $(PY) scripts/diag_smoke.py

# the same against the port (minio_tpu_torch): a 2-worker pool of its
# server on the card (MINIO_TPU_TORCH_DEVICE=cpu runs it on the CPU rung)
diag-smoke-torch:
	$(PY) -m minio_tpu_torch.scripts.diag_smoke
