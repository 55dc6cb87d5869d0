"""The interprocedural engine of the port's miniovet (call graph, whole-
program passes, incremental cache, machine-readable output): the JAX
package's cases (``tests/test_analysis_interproc.py``), fixtures through
both analyzers (``test_torch_analysis.Both``)."""

from tests.test_torch_analysis import check_replaced, load_reference_tests

REPLACED: dict[str, str] = {}
BOTH = load_reference_tests("test_analysis_interproc", globals(), REPLACED)


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


def test_fixture_cases_went_through_both_analyzers():
    assert BOTH.calls >= 20
