"""The reference's ``tests/test_cache_segments.py``, run as written against the port
(``tests/test_torch_suites.py``)."""

from tests.test_torch_suites import check_replaced, load_port_suite, suite_backend

REPLACED: dict[str, str] = {
    "test_concurrent_overwrites_and_heals_never_serve_stale":
        "the reference's body, unchanged, at the backend its suite sets (the numpy host "
        "plane): on the CPU rung each PUT's stripe blocks wait on the plain torch "
        "HighwayHash while the case's 4 readers hold the GIL, and the case runs past "
        "CASE_LIMIT_S (tests/torch_rung_timing.py); chip_smoke.py runs it on the card's "
        "route, where K1 carries its PUTs",
}

load_port_suite("test_cache_segments", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


def test_concurrent_overwrites_and_heals_never_serve_stale(tmp_path):
    with suite_backend():
        REFERENCE_CASES["test_concurrent_overwrites_and_heals_never_serve_stale"](tmp_path)  # noqa: F821
