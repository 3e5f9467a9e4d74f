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
        kr.main([])


# A step loop in both of cuobjdump's spellings of a branch target: a label
# (.L_x_N) and a hex address.  Each loop holds a forward branch and a
# self-branch after the kernel's EXIT, which are not its back-edge.
LOOP_BODY = """\
        /*0040*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0050*/                   IMAD.WIDE.U32 R6, R5, -0x2daee0ad, RZ ;
        /*0060*/                   LOP3.LUT R7, R7, c[0x0][0x210], R8, 0x96, !PT ;
        /*0070*/                   IADD3 R9, R0, 0x1715609d, RZ ;
        /*0080*/                   SHF.R.U32.HI R2, RZ, 0x8, R2 ;
        /*0090*/                   I2FP.F32.U32 R2, R2 ;
        /*00a0*/                   FSETP.GT.AND P1, PT, R5, 3.1415927410125732422, PT ;
        /*00b0*/              @!P1 BRA {fwd} ;
        /*00c0*/                   FSEL R5, R5, R2, P1 ;
        /*00d0*/                   FFMA R5, R4, R4, R5 ;
        /*00e0*/                   MUFU.RSQ R6, R5 ;
        /*00f0*/               @P0 BRA {back} ;
        /*0100*/                   STG.E [R2.64], R5 ;
        /*0110*/                   EXIT ;
"""
SASS_LABELS = ("""\
\t\tFunction : _Z4loopPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ;
        /*0020*/                   MOV R3, RZ ;
        /*0030*/                   MOV R4, RZ ;
.L_x_0:
""" + LOOP_BODY.format(fwd="`(.L_x_1)", back="`(.L_x_0)").replace(
    "        /*00c0*/", ".L_x_1:\n        /*00c0*/") + """\
.L_x_2:
        /*0120*/                   BRA `(.L_x_2);
""")
SASS_HEX = SASS_LABELS.replace("`(.L_x_0)", "0x40").replace(
    "`(.L_x_1)", "0xc0").replace("`(.L_x_2)", "0x120")


@pytest.mark.parametrize("text", [SASS_LABELS, SASS_HEX],
                         ids=["labels", "addresses"])
def test_parse_sass_counts_the_step_loop(text):
    """The loop runs from the back-edge's target to the back-edge, both
    included: 12 instructions, each group counted; the integer groups
    are their own; the self-branch after EXIT is no loop."""
    counts = kr.parse_sass(text)["_Z4loopPf"]
    assert counts["total"] == 19
    loop = counts["loop"]
    assert loop["total"] == 12
    assert (loop["LDG/STG"], loop["IMAD*"], loop["LOP3"], loop["IADD3"],
            loop["SHF"], loop["I2F/F2I"]) == (1, 1, 1, 1, 1, 1)
    assert (loop["FSETP/ISETP"], loop["FSEL/SEL"], loop["FFMA/FMUL/FADD"],
            loop["MUFU"]) == (1, 1, 1, 1)
    assert counts["FSETP/ISETP"] == 2 and "STG" not in loop


def test_parse_sass_without_a_loop_has_none():
    assert "loop" not in kr.parse_sass(SASS)["_Z4stepPf"]


@pytest.mark.parametrize("text", [SASS_LABELS, SASS_HEX],
                         ids=["labels", "addresses"])
def test_parse_sass_counts_the_body(text):
    """The body runs to the branch to itself after the last ``EXIT``, that
    branch left out: the 18 instructions before it; a kernel without one
    has no body."""
    counts = kr.parse_sass(text)["_Z4loopPf"]
    assert counts["body"]["total"] == 18
    assert counts["body"]["LDG/STG"] == 2
    assert "body" not in kr.parse_sass(SASS)["_Z4stepPf"]


def test_floors_of_a_loop():
    """Issue at 4 warp instructions a clock an SM; fp32 at 128 results,
    int at 64, MUFU at 16, each on 132 SMs."""
    counts = {"total": 640, "FFMA/FMUL/FADD": 256, "IMAD*": 32, "LOP3": 16,
              "IADD3": 8, "SHF": 8, "MUFU": 4}
    f = kr.floors_ms(counts, 132 * 1e9, 1e9)
    assert f["issue"] == pytest.approx(1e3 * 640 / 128)
    assert f["fp32"] == pytest.approx(1e3 * 256 / 128)
    assert f["int"] == pytest.approx(1e3 * 64 / 64)
    assert f["mufu"] == pytest.approx(1e3 * 4 / 16)


@pytest.mark.parametrize("demangled,prefix", [
    ("void (anonymous namespace)::ekf_rollout_kernel<1, false>(const float "
     "*, const float *, float *, float *, float *, (anonymous namespace)"
     "::EkfParams)", "ekf_rollout_kernel<1, false"),
    ("void (anonymous namespace)::ekf_rollout_kernel_lanes<1, true>(const "
     "float *, const float *, float *, float *, float *, (anonymous "
     "namespace)::EkfParams)", "ekf_rollout_kernel_lanes<1, true"),
    ("void <unnamed>::expand_seg_kernel(const float *, const int *, const "
     "int *, const unsigned char *, float *, int, int)", "expand_seg_kernel"),
    ("void <unnamed>::wide_boundary_kernel(const float *, const float *, "
     "const unsigned char *, const float *, int *, int *, unsigned char *, "
     "int *, int, int)", "wide_boundary_kernel"),
    ("void <unnamed>::boundary_kernel<true>(const float *, const float *, "
     "const float *, float, unsigned char *, const float *, int *, int, "
     "int)", "boundary_"),
    ("void <unnamed>::expand_range_kernel(const float *, const int *, const "
     "unsigned char *, float *, int, int)", "expand_range_kernel"),
    ("void <unnamed>::compact_kernel(const float *, const int *, const int "
     "*, const unsigned char *, float *, int *, int *, int, int, int)",
     "compact_kernel"),
    ("void <unnamed>::compressed_range_kernel(const float *, const int *, "
     "const int *, const unsigned char *, float *, int, int)",
     "compressed_range_kernel"),
    ("void (anonymous namespace)::compressed_window_kernel(const float *, "
     "const int *, const int *, const unsigned char *, float *, int, int)",
     "compressed_window_kernel"),
])
def test_report_counts_k1_and_the_segmented_expand(demangled, prefix):
    """K1 in the flagship's mode and its small-batch form in the
    sweep's, the segmented K3b, K5a, the single filter's K3a and K3b,
    and K3c and both forms of K3d are among the kernels whose opcodes
    (and loops) the report prints."""
    assert prefix in kr.SASS_KERNELS
    assert kr._short(demangled).startswith(prefix)
    others = [p for p in kr.SASS_KERNELS if p != prefix]
    assert not any(kr._short(demangled).startswith(p) for p in others)
