"""Set-up for the whole test run, loaded before ``tests/conftest.py``.

``memo_tpu.native.build`` compiles libms on first use into one temporary
path of a cache under ``$HOME`` and then renames it into place. Under
pytest-xdist, workers that start with an empty cache compile it at the same
time into that one path; a worker whose load then fails keeps the failure
for its life, and its libms tests skip as "libms unavailable" (52 tests of
``tests/test_moni_semantics.py`` in one run, with nothing failed). So the
controlling process builds the library once, before any worker starts, and
the workers find it built. The build module is loaded from its file, so
that nothing here imports JAX; a run on the real device
(``MEMO_TPU_TEST_REAL_DEVICE``, the port's card tests) builds nothing.
"""

import importlib.util
import os
import pathlib


def pytest_configure(config):
    if hasattr(config, "workerinput") or os.environ.get("MEMO_TPU_TEST_REAL_DEVICE"):
        return  # an xdist worker (the controller has built it), or a card run
    path = pathlib.Path(__file__).resolve().parent / "memo_tpu" / "native" / "build.py"
    spec = importlib.util.spec_from_file_location("_memo_tpu_native_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.load_libms()
