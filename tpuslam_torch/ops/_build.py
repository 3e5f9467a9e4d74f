"""Build the package's CUDA sources into one shared library at first use,
and the checks every kernel wrapper makes before a launch.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one process per
source, all at once, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes``.  The
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

import torch

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"

# No --use_fast_math: it would turn sinf/cosf into __sinf/__cosf and break
# the noise-free parity with the plain path.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

#: The sources with a ``tpuslam_occupancy_<source>`` entry point.
OCCUPANCY_SOURCES = ("pf_step", "resample", "pf_batch", "pf_wide")

_lib: ctypes.CDLL | None = None
#: The loaded library's path, the seconds its build took (0.0 when it was
#: already built) and the compiler's report (``ptxas -v``: registers,
#: stack frames, spills) of its build, kept beside it.
library_path: pathlib.Path | None = None
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "tpuslam_ekf_rollout": [ptr, ptr, ptr, ptr, ptr, ptr,
                                ctypes.c_longlong, ctypes.c_uint32,
                                ctypes.c_uint32, c_int, c_int, c_int, ptr],
        "tpuslam_pf_step": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int,
                            c_int, ptr, ptr, ptr],
        "tpuslam_resample_boundary": [ptr, ptr, ptr, c_float, ptr, ptr, ptr,
                                      c_int, c_int, ptr],
        "tpuslam_resample_expand": [ptr, ptr, ptr, ptr, c_int, c_int, ptr],
        "tpuslam_resample_arrivals": [ctypes.POINTER(ctypes.c_uint)],
        "tpuslam_resample_expand_seg": [ptr, ptr, ptr, ptr, ptr, c_int,
                                        c_int, ptr],
        "tpuslam_resample_compact": [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                     c_int, c_int, ptr],
        "tpuslam_resample_expand_compressed": [ptr, ptr, ptr, ptr, ptr,
                                               c_int, c_int, c_int, ptr],
        "tpuslam_pf_batch_step": [ptr, ptr, c_int, c_int, ptr],
        "tpuslam_pf_step_ticket": [ctypes.POINTER(ctypes.c_uint)],
        "tpuslam_wide_boundary": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  c_int, c_int, ptr],
        "tpuslam_wide_stats": [ptr, ptr, c_int, c_int, ptr],
    }
    signatures.update({f"tpuslam_occupancy_{src}": [
        c_int, c_int, ctypes.POINTER(c_int),
        ctypes.POINTER(ctypes.c_char_p)] for src in OCCUPANCY_SOURCES})
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    return lib


def _check_checkout() -> None:
    if not (_PKG_DIR.parent / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{_PKG_DIR} is not inside a source checkout (no pyproject.toml "
            "beside it); the CUDA kernels build into the checkout's build/ "
            "and need one")


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` with the current CUDA index filled in where it has none."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_constant(values, like: torch.Tensor) -> torch.Tensor:
    """Python ``values`` as a tensor of ``like``'s dtype on its device,
    with no host synchronisation: on a CUDA device the values go through
    pinned host memory and a non-blocking copy (a plain ``torch.tensor``
    on the device waits for the copy)."""
    t = torch.tensor(values, dtype=like.dtype)
    if like.device.type == "cuda":
        return t.pin_memory().to(like.device, non_blocking=True)
    return t.to(like.device)


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is exactly what a kernel reads through a raw
    pointer: this shape and dtype, on ``device``, contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, kernel on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_library(device: torch.device) -> ctypes.CDLL:
    """The kernel library for a launch on ``device``; raises where CUDA is
    not available (a CUDA request never falls back to the plain path)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel launch on {device} requested but CUDA "
                           "is not available")
    return load_library()


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise if any fails; return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """Return the loaded kernel library, building it first if needed.

    Each source is compiled by its own ``nvcc``, all started together;
    one more ``nvcc`` links the objects into the shared library.
    """
    global _lib, library_path, build_seconds, build_log
    if _lib is not None:
        return _lib
    _check_checkout()
    sources, digest = _sources()
    target = BUILD_DIR / f"tpuslam_torch_kernels-{digest}.so"
    log_path = target.with_suffix(".log")
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                            for src, obj in zip(sources, objs)])
            lib_tmp = os.path.join(tmp, target.name)
            log += _run_all([[nvcc, *NVCC_LINK_FLAGS, "-o", lib_tmp, *objs]])
            log_path.write_text(log)
            os.replace(lib_tmp, target)
        build_seconds = time.perf_counter() - t0
    build_log = log_path.read_text() if log_path.exists() else ""
    _lib = _declare(ctypes.CDLL(str(target)))
    library_path = target
    return _lib
