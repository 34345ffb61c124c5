"""The chessboard cell's cut for the CPU tests under ``tests/``: a
fixture of every test there puts the 5 x 6 board (ch5-6.b3, 1,800 x
1,200) into ``tests/conftest.py``'s ``TINY_CONFIGS`` before the test's
own fixtures run, whichever modules are collected, so that no ``mini``
run of ``ch7-9.b3-p42013`` builds the 105,840 x 17,640 matrix and its
dense reference on the CPU.  Run the tests from the root of the repo
(``python -m pytest portbench/tests``), where pytest loads this file."""

import os

import pytest

TESTS_CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "conftest.py")
CUTS = {"simc_ch7-9.b3": {"rows": 5, "cols": 6}}


@pytest.fixture(autouse=True)
def _tiny_chessboard(request, monkeypatch):
    tests = [m for m in request.config.pluginmanager.get_plugins()
             if getattr(m, "__file__", None) == TESTS_CONFTEST]
    for mod in tests:
        for name, cut in CUTS.items():
            monkeypatch.setitem(mod.TINY_CONFIGS, name, cut)
