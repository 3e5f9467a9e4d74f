"""Build the package's CUDA sources into one shared library at first use;
the checks every kernel wrapper makes before a launch, and the one launch
path they all take.

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

Every kernel wrapper in ``ops/`` launches through :func:`launch`; what a
launch needs that depends only on the configuration and the device (a
kernel's filled parameters, truth tables) is built once by :func:`cached`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
import typing

import torch

from tpuslam_torch.ops.fastmath import _MASK32
from tpuslam_torch.utils.profiling import span

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

#: Particles, boundaries and integer prefixes below this are exact in
#: float32: the kernels' bound on a filter's particles.
MAX_N = 1 << 24
#: The kernels' noise modes: none, Philox, injected normals.
MODE_OFF, MODE_PHILOX, MODE_NORMALS = 0, 1, 2

#: Launches since this count was last cleared, by kernel form:
#: ``ekf_rollout`` and ``ekf_rollout_lanes`` (K1's one-thread and
#: small-batch forms), ``pf_step`` (K2), ``resample_boundary`` (K3a on the
#: gate), ``resample_boundary_weights`` (K3a on given weights),
#: ``resample_expand``, ``resample_expand_seg`` (K3b), ``compact``,
#: ``compact_seg`` (K3c), ``expand_compressed``, ``expand_compressed_seg``
#: (K3d), ``pf_batch_step`` (K4), ``wide_boundary`` (K5a), ``wide_stats``
#: (K5b), ``div_by_const`` (the check of K2b's, K4's and K5b's quotients).
launches: collections.Counter = collections.Counter()
#: The C entries that read, by kernel form, the count of a PF kernel's
#: warp-passes whose landmark quotients needed the IEEE divide
#: (``csrc/pf_math.cuh::predict_loglik_n``): :func:`div_fallbacks`.
DIV_FALLBACK_ENTRIES = {"pf_step": "tpuslam_pf_step_div_fallbacks",
                        "pf_batch_step": "tpuslam_pf_batch_div_fallbacks",
                        "wide_stats": "tpuslam_pf_wide_div_fallbacks"}
#: Entries built into :func:`cached`'s cache since this count was last
#: cleared, by kind (the key's first item); over the same launches,
#: ``1 - builds[kind] / launches[form]`` is a plan cache's hit share.
builds: collections.Counter = collections.Counter()
# Launch plans and tables by ``(kind, ...)``: one a configuration and
# device, so nothing here grows with a batch or a seed.
_CACHE: dict = {}

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
        "tpuslam_pf_step": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                            ctypes.c_uint32, ctypes.c_uint32, c_float, c_int,
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
        "tpuslam_pf_batch_step": [ptr, ptr, ctypes.c_uint32, ctypes.c_uint32,
                                  c_int, c_int, ptr],
        "tpuslam_pf_step_ticket": [ctypes.POINTER(ctypes.c_uint)],
        "tpuslam_wide_boundary": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  c_int, c_int, ptr],
        "tpuslam_wide_stats": [ptr, ptr, ctypes.c_uint32, ctypes.c_uint32,
                               c_int, c_int, c_int, ptr],
        "tpuslam_div_by_const": [ptr, ptr, ctypes.c_longlong, c_float,
                                 c_float, c_int, ptr],
    }
    signatures.update({entry: [ctypes.POINTER(ctypes.c_uint)]
                       for entry in DIV_FALLBACK_ENTRIES.values()})
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


def noise_mode(noise_on: bool, normals: torch.Tensor | None) -> int:
    """The kernels' noise mode: injected ``normals`` (noise on only),
    else Philox with noise on, else none."""
    if normals is not None:
        if not noise_on:
            raise ValueError("normals given with noise_on=False")
        return MODE_NORMALS
    return MODE_PHILOX if noise_on else MODE_OFF


def seed_words(seed: int) -> tuple[int, int]:
    """The Philox key of ``seed``: its low and high 32-bit words."""
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32


def ptr(t: torch.Tensor | None) -> int | None:
    """``t``'s device address for a C entry; ``None`` (a null pointer) for
    no tensor."""
    return None if t is None else t.data_ptr()


def cached(key: tuple, build: typing.Callable[[], typing.Any]):
    """The cache's entry under ``key`` (``(kind, ...)``, the rest naming a
    configuration and device), built by ``build()`` at its first use and
    kept; :data:`builds` counts the build under ``kind``."""
    value = _CACHE.get(key)
    if value is None:
        value = _CACHE[key] = build()
        builds[key[0]] += 1
    return value


class Plan(typing.NamedTuple):
    """What a launch of one kernel for one configuration and device needs
    besides its per-call arguments, buffers and stream."""

    entry: typing.Callable[..., int]  # the library's C entry
    index: int | None  # the device's CUDA index
    params: ctypes.Structure  # read-only template; the entry copies it
    params_ptr: int
    extra: tuple = ()  # what else the kernel's launch reads, by its wrapper


def plan(key: tuple, device: torch.device, entry: str,
         make_params: typing.Callable[[], ctypes.Structure],
         make_extra: typing.Callable[[], tuple] = tuple,
         span_name: str | None = None) -> Plan:
    """The :class:`Plan` cached under ``key``, built at its first launch
    (inside the span ``span_name``, where one is given): the library's
    ``entry`` (raises where CUDA is not available), the template
    ``make_params()``, whose per-call fields stay 0 and which no call
    writes (``ctypes`` releases the interpreter lock during a call, so a
    shared template written between calls would be a race), and
    ``make_extra()``."""
    def build():
        with span(span_name) if span_name else contextlib.nullcontext():
            lib = cuda_library(device)
            params = make_params()
            return Plan(getattr(lib, entry), device.index, params,
                        ctypes.addressof(params), make_extra())
    return cached(key, build)


def _on_device(entry: typing.Callable[..., int], index: int | None,
               args: tuple) -> int:
    """``entry(*args)`` with CUDA device ``index`` current: a direct call
    where it already is, else under its guard."""
    if torch.cuda.current_device() == index:
        return entry(*args)
    with torch.cuda.device(index):
        return entry(*args)


def launch(form: str, entry: typing.Callable[..., int], index: int | None,
           *args) -> None:
    """Launch ``entry(*args, stream)`` on device ``index``'s current raw
    stream; raise a ``RuntimeError`` naming the entry where it returns an
    error, else count the launch under ``form`` in :data:`launches`."""
    rc = _on_device(entry, index,
                    args + (torch._C._cuda_getCurrentRawStream(index),))
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {rc}")
    launches[form] += 1


def read_word(entry: str, device: torch.device | str) -> int:
    """The unsigned word that the library's ``entry`` copies from
    ``device`` (a counter of the kernels' own).  Synchronises with the
    device: for checks only."""
    device = resolve_device(device)
    value = ctypes.c_uint(0)
    fn = getattr(cuda_library(device), entry)
    rc = _on_device(fn, device.index, (ctypes.byref(value),))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return value.value


def div_fallbacks(device: torch.device | str) -> dict[str, int]:
    """K2b's, K4's and K5b's counts on ``device``, by kernel form, of the
    warp-passes whose landmark quotients needed the IEEE divide, since
    the library was loaded (modulo 2**32).  Synchronises with the device:
    for checks only."""
    return {form: read_word(entry, device)
            for form, entry in DIV_FALLBACK_ENTRIES.items()}


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
