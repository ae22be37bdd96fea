"""Settings of every pytest run from the repo's root: every test runs under
one time limit, and where tests/conftest.py has loaded JAX, a ``shard_map``
called outside ``jax.jit`` runs as one compiled program.

The limit covers a test's setup, call and teardown together. SIGALRM fails
the phase that is running when it expires (xdist runs each worker's tests
in its main thread, where Python handles signals). The handler runs only
once control is back in Python, so a test stuck in C code is not ended: 30 s
after the limit every thread's stack is dumped to the real stderr instead.

JAX runs an eager ``shard_map`` one primitive at a time, and each primitive
is an XLA compile of its own: the JAX package's distributed tests call their
entry points eagerly, and took minutes each that way. Staged through
``jax.jit``, the same body is one program; the host code around it still
runs eagerly.
"""

import faulthandler
import os
import signal
import sys
import time

import pytest

# seconds: about twice the slowest test, the 25-trial eager band join of
# tests/test_band_join.py (440-500 s on an 8-core host: each trial lowers
# its interpret-mode Pallas kernel anew)
TEST_TIME_LIMIT = 900
_STDERR = pytest.StashKey[int]()
_DEADLINE = pytest.StashKey[float]()


def pytest_configure(config):
    config.stash[_STDERR] = os.dup(2)  # capture is not running yet
    # xdist hands out the files with the most tests first, and so started
    # the slowest file, tests/test_band_join.py (31 tests), last of all:
    # in collection order it starts first
    config.option.loadscopereorder = False
    if "jax" not in sys.modules:  # only tests/conftest.py imports JAX
        return
    import jax
    from jax._src import core

    def compiled_shard_map(trace, prim, fun, args, **params):
        return jax.jit(lambda *xs: prim.bind(fun, *xs, **params))(*args)

    core.EvalTrace.process_shard_map = compiled_shard_map


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    item.stash[_DEADLINE] = time.monotonic() + TEST_TIME_LIMIT
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT + 30, exit=False,
                                      file=item.config.stash[_STDERR])
    yield
    faulthandler.cancel_dump_traceback_later()


def _limited(item):
    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past the {TEST_TIME_LIMIT} s limit "
                    f"of conftest.py")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL,
                     max(item.stash[_DEADLINE] - time.monotonic(), 1e-3))
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, previous)


pytest_runtest_setup = pytest.hookimpl(hookwrapper=True)(_limited)
pytest_runtest_call = pytest.hookimpl(hookwrapper=True)(_limited)
pytest_runtest_teardown = pytest.hookimpl(hookwrapper=True)(_limited)
