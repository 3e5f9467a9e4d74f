"""What the compiler and the occupancy calculator say about the built
kernels: each kernel's registers, stack frame and spills (``ptxas -v``,
kept beside the library by :mod:`tpuslam_torch.ops._build`), the SASS
opcode counts of the particle-filter kernels (``cuobjdump -sass`` of the
library) and each PF kernel's resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, through one
``tpuslam_occupancy_<source>`` entry point a source).

On a CUDA host, from the repository root::

    python -m tpuslam_torch.utils.kernel_report

builds the library if needed and prints one line a kernel of each
report; ``chip_smoke.py`` prints the same lines after its build.  The
opcode counts are static (instructions in the binary, not executed ones).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess

#: Kernels whose opcodes are counted (demangled-name prefixes): K2b, K4
#: and the fused K5b, each in Philox mode.
SASS_KERNELS = ("pf_step_kernel<1, true>", "pf_batch_kernel<1",
                "wide_stats_kernel<1, true")
#: Opcode groups of the count, by the opcode's first dotted part.
OPCODE_GROUPS = (("LDL/STL", ("LDL", "STL")), ("LDC", ("LDC",)),
                 ("LDG/STG", ("LDG", "STG")), ("LDS/STS", ("LDS", "STS")),
                 ("MUFU", ("MUFU",)), ("BAR", ("BAR",)),
                 ("SHFL", ("SHFL",)), ("IMAD*", ("IMAD",)),
                 ("FFMA/FMUL/FADD", ("FFMA", "FMUL", "FADD")),
                 ("CALL", ("CALL",)))

_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")


def _cuda_tool(name: str) -> str | None:
    """``name`` on ``PATH``, under ``CUDA_HOME/bin`` or in Triton's copy
    of the toolkit's binaries; None where none has it."""
    found = shutil.which(name)
    if found:
        return found
    dirs = [pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
            / "bin"]
    try:
        import triton
        dirs.append(pathlib.Path(triton.__file__).parent / "backends"
                    / "nvidia" / "bin")
    except ImportError:
        pass
    for d in dirs:
        if (d / name).exists():
            return str(d / name)
    return None


def _short(demangled: str) -> str:
    """``void ns::f<(int)1, true>(A, B)`` -> ``f<1, true>``."""
    d = demangled.strip()
    if d.endswith(")"):  # drop the parameter list
        depth = 0
        for i in range(len(d) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0:
                d = d[:i]
                break
    d = d.replace("(bool)1", "true").replace("(bool)0", "false")
    d = re.sub(r"\((?:int|unsigned int)\)", "", d)
    d = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", d)
    return d.removeprefix("void ").strip()


def short_names(mangled: list[str]) -> dict[str, str]:
    """Mangled kernel names to short demangled ones
    (``wide_stats_kernel<1, true>``); a name stays mangled where no
    demangler is found."""
    tool = _cuda_tool("c++filt") or _cuda_tool("cu++filt")
    if not tool or not mangled:
        return {m: m for m in mangled}
    out = subprocess.run([tool], input="\n".join(mangled), text=True,
                         capture_output=True, check=True,
                         timeout=60).stdout.splitlines()
    return {m: _short(d) or m for m, d in zip(mangled, out)}


def ptxas_table(log: str) -> dict[str, dict]:
    """Each entry function's registers, stack frame and spill stores and
    loads in bytes, from the ``ptxas -v`` lines of a build log, by
    mangled name."""
    table, props, current, props_for = {}, {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props_for = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props[props_for] = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            stack, st, ld = props.get(current, (0, 0, 0))
            table[current] = dict(registers=int(m.group(1)), stack=stack,
                                  spill_stores=st, spill_loads=ld)
            current = None
    return table


def sass_counts(library: pathlib.Path) -> dict[str, dict] | None:
    """Static opcode counts of every kernel in ``library`` by mangled
    name (:func:`parse_sass`); None where no ``cuobjdump`` is found."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    return parse_sass(subprocess.run([tool, "-sass", str(library)],
                                     text=True, capture_output=True,
                                     check=True, timeout=300).stdout)


def parse_sass(text: str) -> dict[str, dict]:
    """Opcode counts (:data:`OPCODE_GROUPS` and ``total``) of each
    ``Function :`` section of ``cuobjdump -sass`` output, by mangled
    name; a predicate (``@!P0``) is not part of the opcode."""
    counts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), {"total": 0})
            continue
        m = _INSTR.match(line)
        if m is None or current is None:
            continue
        op = _PRED.sub("", m.group(1)).split()[0].split(".")[0]
        current["total"] += 1
        for group, bases in OPCODE_GROUPS:
            if op in bases:
                current[group] = current.get(group, 0) + 1
    return counts


def resident_blocks(lib: ctypes.CDLL, n_batch: int) -> list[tuple[str, int]]:
    """``(name, blocks per SM)`` of every kernel an occupancy entry point
    lists; K4 at ``n_batch`` particles a filter."""
    from tpuslam_torch.ops import _build

    rows = []
    for src in _build.OCCUPANCY_SOURCES:
        fn = getattr(lib, f"tpuslam_occupancy_{src}")
        which = 0
        while True:
            blocks, name = ctypes.c_int(0), ctypes.c_char_p(None)
            rc = fn(which, n_batch, ctypes.byref(blocks), ctypes.byref(name))
            if name.value is None:
                break  # past the source's last kernel
            if rc != 0:
                raise RuntimeError(f"occupancy of {name.value.decode()}: "
                                   f"CUDA error {rc}")
            rows.append((name.value.decode(), blocks.value))
            which += 1
    return rows


def report_lines(n_batch: int = 1000) -> list[str]:
    """The three reports, one line a kernel, for the loaded library
    (built first if needed)."""
    from tpuslam_torch.ops import _build

    lib = _build.load_library()
    table = ptxas_table(_build.build_log)
    counts = sass_counts(_build.library_path)
    names = short_names(sorted(set(table) | set(counts or {})))
    lines = [f"ptxas {names[m]}: {t['registers']} registers, {t['stack']} "
             f"bytes stack frame, {t['spill_stores']} bytes spill stores, "
             f"{t['spill_loads']} bytes spill loads"
             for m, t in sorted(table.items(), key=lambda kv: names[kv[0]])]
    if not table:
        lines.append("ptxas: no report (library built by another process "
                     "without its log)")
    wanted = [m for m in sorted(names, key=names.get)
              if names[m].startswith(SASS_KERNELS)]
    if counts is None:
        lines.append("sass opcodes: not measured (no cuobjdump)")
    for m in wanted:
        if counts is not None and m in counts:
            c = counts[m]
            lines.append(f"sass {names[m]}: " + ", ".join(
                f"{g} {c.get(g, 0)}" for g, _ in OPCODE_GROUPS)
                + f", total {c['total']}")
    lines += [f"resident blocks {name}: {blocks} a SM"
              for name, blocks in resident_blocks(lib, n_batch)]
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the kernel report needs a CUDA device")
    for line in report_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
