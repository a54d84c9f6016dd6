"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers it
includes) has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library loaded with ``ctypes`` --
no PyTorch headers, so a build takes seconds.  Libraries go to
``build/torch_kernels/`` beside the package (git-ignored), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when a module is imported: a
kernel builds at its first launch, or ahead of it through
:func:`build_library`.

:class:`CudaKernel` is the launcher every kernel wrapper uses: it checks
the C function's returned ``cudaGetLastError()`` and counts launches in the
plain integer ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build_library",
           "CudaKernel"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda);"
        " the port's CUDA kernels are built from source at first use"
    )


def _library_path(source: Path) -> Path:
    """Named by the source, the shared headers (``csrc/*.cuh``) and the
    flags, so an edit of any of them rebuilds."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Build ``csrc/<name>`` unless it is built already, and return the
    library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library as ``.log``."""
    source = CSRC / name
    lib = _library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    lib.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {name} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


class CudaKernel:
    """A C entry point of one ``csrc/*.cu`` library.

    ``argtypes`` must name every argument (``ctypes.c_void_p`` for each
    pointer and the stream, ``ctypes.c_int`` for each int); the function
    returns the launch's ``cudaGetLastError()`` as an int, and the library
    exports ``oncde_cuda_error_string`` to name it.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def function(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_library(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.oncde_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oncde_cuda_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def helper(self, symbol: str, argtypes, restype):
        """Another C function of the same library (a size query, say);
        calling it counts no launch."""
        self.function()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn

    def __call__(self, *args) -> None:
        err = self.function()(*args)
        if err != 0:
            name = self._lib.oncde_cuda_error_string(err).decode()
            raise RuntimeError(
                f"{self.symbol} ({self.source}) launch failed: CUDA error "
                f"{err} ({name})"
            )
        self.launches += 1
