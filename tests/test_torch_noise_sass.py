"""The instruction counter of ``scripts/torch_noise_sass.py`` on a made-up
SASS listing: it finds the innermost loop with the most ``MUFU.RSQ``,
leaves out a slow path that a forward branch skips, and divides by the
normals (one ``MUFU.RSQ`` each)."""

import importlib.util
from pathlib import Path

import pytest

from torch_pin import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_noise_sass", ROOT / "scripts" / "torch_noise_sass.py")
sass = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass)

# an outer loop (0x0010-0x00e0) around an inner one (0x0030-0x00c0) that
# draws two normals and skips a slow path (0x0070-0x0090) on its fast path
LISTING = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   UIADD3 UR5, UR4, 0x1, URZ ;
        /*0030*/                   IMAD.WIDE.U32 R6, R2, -0x2daee0ad, RZ ;
        /*0040*/                   LOP3.LUT R8, R7, UR5, R3, 0x96, !PT ;
        /*0050*/                   MUFU.RSQ R9, R8 ;
        /*0060*/              @!P0 BRA 0xa0 ;
        /*0070*/                   MOV R10, 0x90 ;
        /*0080*/                   CALL.REL.NOINC 0x200 ;
        /*0090*/                   STL [R1], R9 ;
        /*00a0*/                   FFMA R9, R8, R9, R9 ;
        /*00b0*/                   MUFU.RSQ R11, R9 ;
        /*00c0*/               @P1 BRA 0x30 ;
        /*00d0*/                   STG.E desc[UR4][R4.64], R9 ;
        /*00e0*/               @P2 BRA 0x10 ;
        /*00f0*/                   EXIT ;
        /*0200*/                   RET.REL.NODEC R10 0x0 ;
"""


def test_hot_loop_counts_the_inner_fast_path():
    counts, normals, left_out = sass.hot_loop(sass.parse(LISTING))
    assert normals == 2 and left_out == 3
    assert dict(counts) == {"IMAD.WIDE.U32": 1, "LOP3.LUT": 1,
                            "MUFU.RSQ": 2, "BRA": 2, "FFMA": 1}


@pytest.mark.parametrize("op,cls", [
    ("IMAD.WIDE.U32", "int_multiply"), ("IMAD.HI.U32", "int_multiply"),
    ("IMAD", "int_multiply"), ("IMAD.MOV.U32", "move"), ("IMAD.X", "int_add_compare"),
    ("LOP3.LUT", "lop3_shift"), ("SHF.R.U32.HI", "lop3_shift"),
    ("FFMA.FTZ", "f32_arith"), ("FSEL", "f32_other"), ("MUFU.RSQ", "mufu"),
    ("I2FP.F32.S32", "convert"), ("BSSY", "branch"), ("LDS.128", "load_store"),
    ("UIADD3", "uniform"), ("R2UR", "uniform"), ("NOP", "other")])
def test_op_class(op, cls):
    assert sass.op_class(op) == cls
