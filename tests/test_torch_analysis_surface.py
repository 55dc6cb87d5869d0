"""The observable-surface pass of the port's miniovet: the JAX package's
cases (``tests/test_analysis_surface.py``) on the port's tree, its static
manifest held against a live scrape of the port's server and of a
2-worker pool of ``python -m minio_tpu_torch.server``, and the port's
generated ``minio_tpu_torch/docs/SURFACE.md``."""

import os

from tests.test_torch_analysis import DOCS, check_replaced, load_reference_tests

REPLACED = {
    "test_generated_surface_doc_is_deterministic_and_in_sync":
        "the reference reads the repository's docs/SURFACE.md, the JAX "
        "package's; the port's table is minio_tpu_torch/docs/SURFACE.md",
}
BOTH = load_reference_tests(
    "test_analysis_surface", globals(), REPLACED,
    modules={
        "test_s3_api": ("tests.test_torch_s3_api", {"ServerThread": "PortServerThread"}),
        "test_workers": ("tests.test_torch_workers", {}),
    },
)


def test_generated_surface_doc_is_deterministic_and_in_sync(surface_run):
    _, record = surface_run
    md = rules_surface.generate_surface_md(record)
    assert md == rules_surface.generate_surface_md(record)
    with open(os.path.join(DOCS, "SURFACE.md"), encoding="utf-8") as fh:
        on_disk = fh.read()
    assert on_disk == md, (
        "minio_tpu_torch/docs/SURFACE.md is stale — run `python -m "
        "minio_tpu_torch.analysis --gen-surface`"
    )


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


def test_manifest_is_the_ports_tree(manifest):
    # the port's own series ride the same extraction
    names = {s["name"] for s in manifest["metrics"]}
    assert "minio_tpu_kernel_launches_total" in names
    assert "minio_sanitizer_static_lock_ranks" in names
