"""Build the package's CUDA sources into one shared library at first use.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library goes into ``build/`` at the repository root, named by a hash of
the sources, the headers and the flags, so an edit rebuilds it and an
unchanged tree reuses it.  Nothing here runs when the package is
imported.

The build needs a source checkout (the package beside the repository's
``pyproject.toml``): an installed copy of the package has no repository
root to build into, and :func:`load_library` raises there rather than
write into the interpreter's tree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"

# No --use_fast_math: it would turn sinf/cosf into __sinf/__cosf and break
# the noise-free parity with the plain path.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: ctypes.CDLL | None = None
#: Seconds the last build took (0.0 when the library was already built)
#: and the compiler's report (registers, spills) of that build.
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of tpuslam_torch need the CUDA toolkit")
    return str(path)


def _sources() -> tuple[list[pathlib.Path], str]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    lib.tpuslam_ekf_rollout.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                        ctypes.c_int, ctypes.c_int, ptr]
    lib.tpuslam_ekf_rollout.restype = ctypes.c_int
    return lib


def _check_checkout() -> None:
    if not (_PKG_DIR.parent / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{_PKG_DIR} is not inside a source checkout (no pyproject.toml "
            "beside it); the CUDA kernels build into the checkout's build/ "
            "and need one")


def load_library() -> ctypes.CDLL:
    """Return the loaded kernel library, building it first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    _check_checkout()
    sources, digest = _sources()
    target = BUILD_DIR / f"tpuslam_torch_kernels-{digest}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
    _lib = _declare(ctypes.CDLL(str(target)))
    return _lib
