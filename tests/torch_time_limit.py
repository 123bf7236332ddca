"""A test's own time limit for the port's runtime tests: an autouse
fixture that raises ``TimeoutError`` in the test after ``seconds`` (a
``SIGALRM``), so a hung actor fails that test and not the whole suite.

    _limit = time_limit(240)   # at a test module's top level
"""

import signal

import pytest


def time_limit(seconds: int):
    @pytest.fixture(autouse=True)
    def _limit():
        def on_alarm(signum, frame):
            raise TimeoutError(f"test took over {seconds} s")

        previous = signal.signal(signal.SIGALRM, on_alarm)
        signal.alarm(seconds)
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, previous)

    return _limit
