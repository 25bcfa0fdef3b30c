"""A pytest plugin that runs the port's tests under the port's sanitizers.

Load it with ``-p`` and arm it with ``SIMLINT_SANITIZE=1``::

    SIMLINT_SANITIZE=1 PYTHONPATH=src python -m pytest \\
        -p repro_torch.analysis.pytest_plugin tests/test_torch_engine.py -q

Every test of a ``tests/test_torch_*.py`` file then runs inside the port's
:class:`~.sanitize.LockOrderSanitizer` (raising on a lock-order cycle among
the locks the test creates), :class:`~.sanitize.AxisSanitizer` (raising on
an ``@axes`` contract violation) and :class:`~.sanitize.RecompileSanitizer`
in record-only mode (a test's first build of a dispatch key is legitimate;
the steady-state budgets are held by ``tests/test_torch_simlint.py`` and on
the card).  Tests marked ``no_sanitize`` — those that patch ``threading``
or assert sanitizer behaviour themselves — run unwrapped.  Without
``SIMLINT_SANITIZE=1`` the plugin does nothing.  The repository's own
``SIMLINT_SANITIZE=1`` harness (``tests/conftest.py``) wraps every test in
the reference's sanitizers as well; the two nest, each restoring the
other's lock factories.
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest

from .sanitize import AxisSanitizer, LockOrderSanitizer, RecompileSanitizer


@pytest.fixture(autouse=True)
def _repro_torch_sanitizers(request):
    if (
        os.environ.get("SIMLINT_SANITIZE") != "1"
        or not Path(str(request.node.fspath)).name.startswith("test_torch_")
        or request.node.get_closest_marker("no_sanitize") is not None
    ):
        yield
        return
    with LockOrderSanitizer():
        with RecompileSanitizer(record_only=True):
            with AxisSanitizer():
                yield
