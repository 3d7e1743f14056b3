"""Test folders removed once their tests have passed.

A CLI or checkpoint test of the port writes its run's checkpoints, each
with the flagship's networks and, mostly, their Adam states (~0.4-1.6 GB
a test), and pytest keeps the folders of its last three runs. A test
module that imports `tmp_path` from here has each test's folder removed
after the test passed; `kept_if_failed` does the same for a module
fixture's folder. A folder stays where a test failed meanwhile.
"""

import contextlib
import shutil

import pytest


@contextlib.contextmanager
def kept_if_failed(request, path):
    """Remove `path` on leaving unless a test failed meanwhile."""
    failed = request.session.testsfailed
    yield path
    if request.session.testsfailed == failed:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path, request):
    """pytest's `tmp_path`, removed after the test if it passed."""
    with kept_if_failed(request, tmp_path):
        yield tmp_path
