"""The reference's ``tests/test_select_sql.py``, run as written against the port
(``tests/test_torch_suites.py``)."""

from tests.test_torch_suites import check_replaced, load_port_suite

REPLACED: dict[str, str] = {}

load_port_suite("test_select_sql", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)
