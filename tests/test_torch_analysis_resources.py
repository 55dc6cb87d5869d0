"""The resources and error-taint passes and the leak witness of the port's
miniovet: the JAX package's cases (``tests/test_analysis_resources.py``),
fixtures through both analyzers (``test_torch_analysis.Both``), the
ownership table's facts on the port's own tree, and the leak witness
against the port's classes."""

from tests.test_torch_analysis import check_replaced, load_reference_tests

REPLACED: dict[str, str] = {}
BOTH = load_reference_tests("test_analysis_resources", globals(), REPLACED)


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


def test_fixture_cases_went_through_both_analyzers():
    assert BOTH.calls >= 20
