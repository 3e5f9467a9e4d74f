"""What the compiler and the occupancy calculator say about the built
kernels: each kernel's registers, stack frame and spills (``ptxas -v``,
kept beside the library by :mod:`tpuslam_torch.ops._build`), the SASS
opcode counts of K1, K2b, K3a, K4, K5a, K5b, K3c and both forms of K3b
and of K3d (``cuobjdump -sass`` of the library), those of each such kernel's
largest loop (the instructions from a backward branch's target to the
branch: K1's step loop) and of its body (the instructions before the
branch to itself that follows the kernel's last ``EXIT``: the
subroutines after it, such as the IEEE divide's slow path, left out),
and each PF kernel's resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, through one
``tpuslam_occupancy_<source>`` entry point a source).

On a CUDA host, from the repository root::

    python -m tpuslam_torch.utils.kernel_report

builds the library if needed and prints one line a kernel of each
report; ``chip_smoke.py`` prints the same lines after its build.  With
the path of a built library (another checkout's ``build/*.so``) it prints
only that library's opcode counts.  The opcode counts are static
(instructions in the binary, not executed ones).
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import re
import shutil
import subprocess

#: Kernels whose opcodes are counted (demangled-name prefixes): K1 in the
#: flagship's mode (Philox, no NEES) and its small-batch form in the
#: sweep's (Philox, NEES), K2b, K4 and the fused K5b in Philox mode, K5a,
#: the single filter's K3a (every ``boundary_`` kernel of ``resample.cu``)
#: and both forms of K3b (single and segmented).
SASS_KERNELS = ("ekf_rollout_kernel<1, false",
                "ekf_rollout_kernel_lanes<1, true", "pf_step_kernel<1, true>",
                "pf_batch_kernel<1", "wide_boundary_kernel",
                "wide_stats_kernel<1, true", "expand_seg_kernel",
                "expand_range_kernel", "boundary_", "compact_kernel",
                "compressed_range_kernel", "compressed_window_kernel")
#: Opcode groups of the count, by the opcode's first dotted part.
OPCODE_GROUPS = (("LDL/STL", ("LDL", "STL")), ("LDC", ("LDC",)),
                 ("LDG/STG", ("LDG", "STG")), ("LDS/STS", ("LDS", "STS")),
                 ("MUFU", ("MUFU",)), ("BAR", ("BAR",)),
                 ("SHFL", ("SHFL",)), ("IMAD*", ("IMAD",)),
                 ("LOP3", ("LOP3",)), ("IADD3", ("IADD3",)),
                 ("SHF", ("SHF",)),
                 ("I2F/F2I", ("I2F", "F2I", "I2FP", "F2IP")),
                 ("FSETP/ISETP", ("FSETP", "ISETP")),
                 ("FSEL/SEL", ("FSEL", "SEL")),
                 ("FFMA/FMUL/FADD", ("FFMA", "FMUL", "FADD")),
                 ("CALL", ("CALL",)))
#: The groups of each issue pipe's floor and the pipe's results a clock
#: an SM on sm_90 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput, compute capability 9.0): float32 add, multiply and
#: multiply-add at 128; 32-bit integer multiply, add, logic and shift at
#: 64; the special functions (MUFU) at 16.
PIPES = (("fp32", ("FFMA/FMUL/FADD",), 128),
         ("int", ("IMAD*", "LOP3", "IADD3", "SHF"), 64),
         ("mufu", ("MUFU",), 16))
#: Warp instructions an SM issues a clock (four schedulers), and the
#: H100 SXM's SMs.
ISSUE_PER_CLOCK = 4
SMS = 132

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


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


@functools.lru_cache(maxsize=4)
def sass_counts(library: pathlib.Path) -> dict[str, dict] | None:
    """Static opcode counts of every kernel in ``library`` by mangled
    name (:func:`parse_sass`); None where no ``cuobjdump`` is found."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    return parse_sass(subprocess.run([tool, "-sass", str(library)],
                                     text=True, capture_output=True,
                                     check=True, timeout=300).stdout)


def counts_of(prefix: str) -> tuple[str, dict] | None:
    """``(short name, opcode counts)`` of the loaded library's first
    kernel, by short name, that starts with ``prefix``; None where no
    ``cuobjdump`` is found or no kernel matches."""
    from tpuslam_torch.ops import _build

    _build.load_library()
    counts = sass_counts(_build.library_path)
    if counts is None:
        return None
    names = short_names(sorted(counts))
    for m in sorted(counts, key=names.get):
        if names[m].startswith(prefix):
            return names[m], counts[m]
    return None


def _group_counts(ops: list[str]) -> dict:
    """``total`` and the :data:`OPCODE_GROUPS` counts of some opcodes."""
    counts = {"total": len(ops)}
    for op in ops:
        for group, bases in OPCODE_GROUPS:
            if op in bases:
                counts[group] = counts.get(group, 0) + 1
    return counts


def _largest_loop(instrs: list[tuple[int, str, str]],
                  labels: dict[str, int]) -> dict | None:
    """The opcode counts of the instructions from the target of the
    backward branch that spans the most addresses to that branch, both
    included; None where no branch goes backward."""
    best = None
    for addr, op, text in instrs:
        if op != "BRA":
            continue
        m = _TARGET.search(text)
        if m is None:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                                16)
        if target is not None and target < addr and (
                best is None or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        return None
    return _group_counts([op for addr, op, _ in instrs
                          if best[0] <= addr <= best[1]])


def _body(instrs: list[tuple[int, str, str]],
          labels: dict[str, int]) -> dict | None:
    """The opcode counts of the instructions before the first branch to
    its own address (the trap after the kernel's last ``EXIT``); None
    where there is none."""
    for i, (addr, op, text) in enumerate(instrs):
        if op != "BRA":
            continue
        m = _TARGET.search(text)
        if m is None:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                                16)
        if target == addr:
            return _group_counts([o for _, o, _ in instrs[:i]])
    return None


def parse_sass(text: str) -> dict[str, dict]:
    """Opcode counts (:data:`OPCODE_GROUPS` and ``total``) of each
    ``Function :`` section of ``cuobjdump -sass`` output, by mangled
    name; a predicate (``@!P0``) is not part of the opcode.  Where a
    branch goes backward, ``loop`` holds the same counts for the largest
    loop (:func:`_largest_loop`): a label (``.L_x_3:``) stands for the
    address of the instruction after it.  ``body`` holds them for the
    instructions before the kernel's branch to itself (:func:`_body`)."""
    functions: dict[str, tuple[list, dict]] = {}
    current = None
    pending: list[str] = []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = functions.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if current is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if m is None:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            current[1][label] = addr
        pending = []
        text_ = _PRED.sub("", m.group(2))
        current[0].append((addr, text_.split()[0].split(".")[0], text_))
    counts = {}
    for name, (instrs, labels) in functions.items():
        counts[name] = _group_counts([op for _, op, _ in instrs])
        for key, part in (("loop", _largest_loop(instrs, labels)),
                          ("body", _body(instrs, labels))):
            if part is not None:
                counts[name][key] = part
    return counts


def floors_ms(counts: dict, executions: float, clock_hz: float) -> dict:
    """The least milliseconds in which the card's SMs issue ``counts``
    (opcode counts of a code path, as :func:`parse_sass` gives them)
    ``executions`` times, once a thread: ``issue`` at
    :data:`ISSUE_PER_CLOCK` warp instructions a clock an SM, and each of
    :data:`PIPES` at its results a clock an SM, at ``clock_hz`` on
    :data:`SMS` SMs."""
    per_s = SMS * clock_hz
    out = {"issue": 1e3 * counts["total"] * executions
           / (32 * ISSUE_PER_CLOCK * per_s)}
    for pipe, groups, rate in PIPES:
        n = sum(counts.get(g, 0) for g in groups)
        out[pipe] = 1e3 * n * executions / (rate * per_s)
    return out


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


def sass_lines(counts: dict | None, names: dict[str, str]) -> list[str]:
    """One line a counted part (whole, largest loop, body) of each of
    :data:`SASS_KERNELS` in ``counts`` (:func:`sass_counts`)."""
    if counts is None:
        return ["sass opcodes: not measured (no cuobjdump)"]
    lines = []
    for m in sorted(names, key=names.get):
        if m not in counts or not names[m].startswith(SASS_KERNELS):
            continue
        for label, c in ((names[m], counts[m]),
                         (f"{names[m]} loop", counts[m].get("loop")),
                         (f"{names[m]} body", counts[m].get("body"))):
            if c is not None:
                lines.append(f"sass {label}: " + ", ".join(
                    f"{g} {c.get(g, 0)}" for g, _ in OPCODE_GROUPS)
                    + f", total {c['total']}")
    return lines


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
    lines += sass_lines(counts, names)
    lines += [f"resident blocks {name}: {blocks} a SM"
              for name, blocks in resident_blocks(lib, n_batch)]
    return lines


def main(argv: list[str]) -> int:
    import torch

    if argv:  # another build's library: its opcode counts only
        counts = sass_counts(pathlib.Path(argv[0]).resolve())
        lines = sass_lines(counts, short_names(sorted(counts or {})))
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the kernel report needs a CUDA device")
        lines = report_lines()
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
