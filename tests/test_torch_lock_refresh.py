"""The reference's ``tests/test_lock_refresh.py``, run as written against the port
(``tests/test_torch_suites.py``)."""

from tests.test_torch_suites import check_replaced, load_port_suite, suite_backend

REPLACED: dict[str, str] = {
    "test_streaming_put_aborts_on_lock_loss":
        "the reference's body, unchanged, at the backend its suite sets (the numpy host "
        "plane): its 20 s abort limit cannot hold on the CPU rung, where one 1 MiB stripe "
        "block at EC 2+2 takes about 10 s in the plain torch HighwayHash "
        "(tests/torch_rung_timing.py) and the stream dispatches two before it aborts",
}

load_port_suite("test_lock_refresh", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


def test_streaming_put_aborts_on_lock_loss(tmp_path, monkeypatch):
    with suite_backend():
        REFERENCE_CASES["test_streaming_put_aborts_on_lock_loss"](tmp_path, monkeypatch)  # noqa: F821
