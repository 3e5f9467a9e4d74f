"""The kernel report's parsers, on the CPU: the ``ptxas -v`` lines of a
build log, ``cuobjdump -sass`` text and demangled kernel names.  The
report itself reads a built library and the card (``chip_smoke.py``
phase 2)."""

import pytest
import torch

from tpuslam_torch.utils import kernel_report as kr

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115pf_batch_kernelILi1EEEv14PfBatchBuffers13PfBatchParamsi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115pf_batch_kernelILi1EEEv14PfBatchBuffers13PfBatchParamsi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4stepPf' for 'sm_90a'
ptxas info    : Function properties for _Z4stepPf
    40 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, 360 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z4stepPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ; /* 0x0 */
        /*0020*/              @!P0 BRA `(.L_x_1) ;                 /* 0x0 */
        /*0030*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0040*/                   FFMA R5, R4, R4, R5 ;
        /*0050*/               @P1 MUFU.RCP R6, R5 ;
        /*0060*/                   CALL.REL.NOINC `(__internal_0) ;
        /*0070*/                   STL [R1], R6 ;
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_ptxas_table_reads_each_entry_function():
    """Registers, stack frame and spills of every entry function, each
    from its own ``Function properties`` line."""
    table = kr.ptxas_table(PTXAS_LOG)
    assert table == {
        "_ZN12_GLOBAL__N_115pf_batch_kernelILi1EEEv14PfBatchBuffers13PfBatchParamsi":
            dict(registers=63, stack=0, spill_stores=0, spill_loads=0),
        "_Z4stepPf": dict(registers=64, stack=40, spill_stores=8,
                          spill_loads=12),
    }


def test_parse_sass_counts_opcode_groups():
    """One count a group, by the opcode's first dotted part, predicates
    stripped; the encoding-only lines are not instructions."""
    counts = kr.parse_sass(SASS)
    step = counts["_Z4stepPf"]
    assert step["total"] == 8
    assert (step["LDC"], step["IMAD*"], step["LDG/STG"]) == (1, 1, 1)
    assert (step["FFMA/FMUL/FADD"], step["MUFU"], step["CALL"]) == (1, 1, 1)
    assert step["LDL/STL"] == 1 and "BAR" not in step
    assert counts["_Z5otherv"] == {"total": 1}


@pytest.mark.parametrize("demangled,short", [
    ("void <unnamed>::pf_batch_kernel<(int)1>(<unnamed>::PfBatchBuffers, "
     "<unnamed>::PfBatchParams, int)", "pf_batch_kernel<1>"),
    ("void (anonymous namespace)::wide_stats_kernel<1, true, false>("
     "(anonymous namespace)::WideBuffers, (anonymous namespace)::WideParams)",
     "wide_stats_kernel<1, true, false>"),
    ("void <unnamed>::pf_step_kernel<(int)1, (bool)1>(const float *)",
     "pf_step_kernel<1, true>"),
    ("<unnamed>::boundary_kernel(const float *, int)", "boundary_kernel"),
])
def test_short_names(demangled, short):
    """Both demanglers' spellings shorten to the name and its template
    arguments, which the opcode report matches by prefix."""
    assert kr._short(demangled) == short


def test_report_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the report is chip_smoke's")
    with pytest.raises(RuntimeError, match="CUDA"):
        kr.main()
