"""The JAX package's native preprocessing library made live before a test
compares a ragged interpolation against the JAX package.

Under ``pytest -n`` every worker imports ``tests/test_native.py``, whose
collection builds ``csrc/libncde_preprocess.so`` in place.  A worker whose
``ctypes.CDLL`` meets the file half written by another worker's ``g++``
caches the failure for the rest of its life (``data/native.py``'s
``_load_failed``), and from then on the JAX package's ``interpolate``
quietly takes its per-length XLA builders, which differ from the native
library (the port's path) in the last bit.  :func:`make_live` clears that
cache and loads the library again, waiting out a build still in progress;
a library that still will not load fails the test, which never falls back.
"""

import time

import pytest

from online_neural_cdes_tpu.data import native as jax_native

__all__ = ["make_live", "jax_native_live"]

# A build started by another worker finishes within seconds.
WAIT_S = 60.0


def make_live(wait_s: float = WAIT_S) -> None:
    """Reset the JAX binding's cached load and load the library; fail the
    calling test if it does not load within ``wait_s`` seconds."""
    deadline = time.monotonic() + wait_s
    while True:
        jax_native._lib = None
        jax_native._load_failed = False
        if jax_native.available():
            return
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native preprocessing library "
                        f"({jax_native._LIB_PATH}) did not load within {wait_s:.0f} s; "
                        "a parity test against its ragged interpolation needs it")
        time.sleep(0.5)


@pytest.fixture
def jax_native_live():
    make_live()
