"""The per-test time limit of the repo's root conftest.py, run in an inner
pytest session whose conftest registers the same hooks with a 1 s limit."""

import pathlib

pytest_plugins = ["pytester"]

CONFTEST = pathlib.Path(__file__).parents[1] / "conftest.py"


def test_time_limit_fails_only_the_tests_that_run_past_it(pytester):
    pytester.makeconftest(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location("outer",
                                                      {str(CONFTEST)!r})
        outer = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(outer)
        outer.TEST_TIME_LIMIT = 1
        pytest_configure = outer.pytest_configure
        pytest_runtest_protocol = outer.pytest_runtest_protocol
        pytest_runtest_setup = outer.pytest_runtest_setup
        pytest_runtest_call = outer.pytest_runtest_call
        pytest_runtest_teardown = outer.pytest_runtest_teardown
    """)
    pytester.makepyfile("""
        import time

        import pytest

        @pytest.fixture
        def slow_setup():
            time.sleep(60)

        def test_sleeps_past_the_limit():
            time.sleep(60)

        def test_setup_sleeps_past_the_limit(slow_setup):
            pass

        def test_ends_in_time():
            time.sleep(0.2)
    """)
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider",
                                           timeout=50)
    result.assert_outcomes(passed=1, failed=1, errors=1)
    result.stdout.fnmatch_lines([
        # pytest reports errors in setup before failures
        "*test_setup_sleeps_past_the_limit ran past the 1 s limit of "
        "conftest.py*",
        "*test_sleeps_past_the_limit ran past the 1 s limit of conftest.py*",
    ])
