"""What ``chip_smoke.py`` works out without a card.

The per-pipe bound of rows 1-10 of PERF.md's kernel table: SASS opcodes
sorted into the pipes they may run on, and the bound as the least time at
which those counts fit the H100's peak rates -- checked against a direct
spread of the counts over the pipes (each class to the pipes it may use,
the scarce pipe first), which fits at the bound and not below it.  And
the builds of ``--base DIR``: one per distinct source of the two trees.
"""

import pathlib
import random
import shutil
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DEV = {"sms": 1, "clock_hz": 1.0}   # seconds are then SM clocks


@pytest.mark.parametrize("op, cls", [
    ("LOP3.LUT", "alu"), ("SHF.L.W.U32.HI", "alu"), ("ISETP.GE.U32.AND",
                                                     "alu"),
    ("I2FP.F32.U32", "alu"), ("SEL", "alu"), ("PRMT", "alu"),
    ("IADD3", "iadd"), ("IADD3.X", "iadd"), ("LEA.HI", "iadd"),
    ("MOV", "iadd"), ("IMAD.MOV.U32", "iadd"), ("IMAD.IADD", "iadd"),
    ("IMAD.SHL.U32", "iadd"), ("IMAD.X", "iadd"),
    ("IMAD", "imad"), ("IMAD.HI.U32", "imad"), ("IMAD.U32", "imad"),
    ("IMAD.WIDE.U32", "imad_wide"), ("IMAD.WIDE", "imad_wide"),
    ("FFMA", "fp32"), ("FMUL.FTZ", "fp32"), ("FADD", "fp32"),
    ("MUFU.RSQ", "xu"), ("MUFU.LG2", "xu"), ("F2I.NTZ", "xu"),
    ("VIADD", "other"), ("BRA", "other"), ("LDS.64", "other"),
])
def test_pipe_class(op, cls):
    assert chip_smoke._pipe_class(op) == cls


def test_pipe_counts_sums_classes():
    ops = ["LOP3.LUT", "IADD3", "IMAD.WIDE.U32", "IMAD.WIDE.U32", "FFMA",
           "BRA"]
    assert chip_smoke._pipe_counts(ops) == {
        "all": 6, "alu": 1, "iadd": 1, "imad_wide": 2, "fp32": 1,
        "other": 1}


def _fits(c, t):
    """Whether counts ``c`` (one value) fit ``t`` SM clocks: the XU, the
    ALU-only and IMAD-only work on their pipes, FP32 on the lite pipe
    first, adds on the ALU first, what is left on the heavy pipe; issue."""
    cap = {k: v * t for k, v in chip_smoke.PIPE_LANES_PER_SM.items()}
    if c.get("all", 0) > chip_smoke.ISSUE_LANES_PER_SM * t:
        return False
    if c.get("xu", 0) > cap["xu"]:
        return False
    alu_left = cap["alu"] - c.get("alu", 0)
    heavy_left = cap["heavy"] - c.get("imad", 0) - 2 * c.get("imad_wide", 0)
    heavy_left -= max(0.0, c.get("fp32", 0) - cap["lite"])
    heavy_left -= max(0.0, c.get("iadd", 0) - max(alu_left, 0.0))
    return alu_left >= 0 and heavy_left >= 0


@pytest.mark.parametrize("counts, clocks, by", [
    ({"all": 128, "iadd": 128}, 1.0, "issue"),        # adds on two pipes
    ({"all": 128, "alu": 128}, 2.0, "alu"),           # LOP3 on the ALU only
    ({"all": 32, "imad_wide": 32}, 1.0, "imad"),      # two heavy passes
    ({"all": 16, "xu": 16}, 1.0, "xu"),
    ({"all": 96, "alu": 64, "iadd": 32}, 1.0, "alu"),  # adds on heavy
    ({"all": 192, "alu": 64, "fp32": 128}, 1.5, "issue"),
    ({"all": 160, "alu": 48, "iadd": 48, "imad": 64}, 160 / 128, "issue"),
    ({"all": 100, "alu": 40, "iadd": 40, "imad_wide": 40}, 1.25, "imad"),
])
def test_pipe_seconds_examples(counts, clocks, by):
    t = chip_smoke.pipe_seconds(1, counts, DEV)
    assert max(t.values()) == pytest.approx(clocks)
    assert t[by] == pytest.approx(clocks)


def test_pipe_seconds_is_the_least_time_that_fits():
    rnd = random.Random(19)
    for _ in range(500):
        c = {k: rnd.choice([0, rnd.uniform(0, 80)])
             for k in ("alu", "iadd", "imad", "imad_wide", "fp32", "xu")}
        c["all"] = sum(c.values()) + rnd.uniform(0, 20)
        t = max(chip_smoke.pipe_seconds(1, c, DEV).values())
        assert _fits(c, t * (1 + 1e-9))
        assert not _fits(c, t * (1 - 1e-6))


def test_ops_bound_takes_the_bytes_when_they_are_slower():
    counts = {"all": 1.0, "alu": 1.0}
    ms, by, note = chip_smoke.ops_bound(
        10, 1e9 * chip_smoke.HBM_BYTES_PER_S, counts, DEV)
    assert by == "bytes" and ms == pytest.approx(1e12)
    ms, by, note = chip_smoke.ops_bound(1280, 0, counts, DEV)
    assert by == "operations" and ms == pytest.approx(1e3 * 1280 / 64)
    assert note.startswith("set by alu")


def test_value_counts_adds_the_tile_key_once_a_tile(monkeypatch):
    per_value = {"philox": {"all": 16.0, "alu": 8.0, "imad_wide": 8.0},
                 "threefry": {"all": 72.0, "alu": 40.0, "iadd": 32.0},
                 "normal_hw": {"all": 55.0, "fp32": 33.0, "alu": 18.0,
                               "xu": 4.0}}
    monkeypatch.setitem(chip_smoke.PIPES, "per_value", per_value)
    tf = chip_smoke.value_counts("project_packed", "threefry", "normal")
    assert tf == {"all": 72 + 55 + 2, "alu": 58.0, "iadd": 32.0,
                  "fp32": 35.0, "xu": 4.0}
    hw = chip_smoke.value_counts("reconstruct_apply_packed", "hw", "normal")
    tile = chip_smoke.TILE_VALUES
    assert hw["all"] == pytest.approx(16 + 55 + 1 + (72 + 18) / tile)
    assert hw["iadd"] == pytest.approx((32 + 18) / tile)
    assert hw["imad_wide"] == 8.0
    un = chip_smoke.value_counts("project_packed", "threefry", "uniform")
    assert un["fp32"] == chip_smoke.FP_OPS_PER_VALUE["uniform"] + 2


def test_ab_builds_are_shared_by_equal_sources(tmp_path):
    """Two trees' kernel sources build to one output where the source and
    every header are equal (``--base`` starts one nvcc for it), to their
    own where either differs."""
    from repro_torch.kernels import build

    other = tmp_path / "csrc"
    shutil.copytree(build.CSRC, other)
    for src in ("rbd_step.cu", "rbd_flat.cu"):
        assert build.output_path(src, other) == build.output_path(src)
    step = other / "rbd_step.cu"
    step.write_text(step.read_text() + "\n// another tree\n")
    assert build.output_path("rbd_step.cu", other) != build.output_path(
        "rbd_step.cu")
    assert build.output_path("rbd_flat.cu", other) == build.output_path(
        "rbd_flat.cu")
    head = other / "philox.cuh"
    head.write_text(head.read_text() + "\n// another tree\n")
    assert build.output_path("rbd_flat.cu", other) != build.output_path(
        "rbd_flat.cu")


def test_materialized_bytes_and_bound():
    """Phase 19 (b)'s byte bounds: the 15.1 GB basis read once, plus the
    vectors; at the H100's HBM rate the projection's bound is ~4.69 ms."""
    d, q = 25, 151_049_216
    b = chip_smoke.materialized_bytes(d, q)
    assert b["project_materialized"] == 4 * d * q + 4 * q + 4 * d
    assert b["reconstruct_apply_materialized"] == 4 * d * q + 4 * d + 8 * q
    ms = 1e3 * b["project_materialized"] / chip_smoke.HBM_BYTES_PER_S
    assert ms == pytest.approx(4.689, abs=1e-3)


def test_gram_error_of_a_basis():
    import torch

    q, _ = torch.linalg.qr(torch.randn(50, 4, dtype=torch.float64))
    assert chip_smoke._gram_error(q.T.float()) < 1e-6
    assert chip_smoke._gram_error(2 * q.T.float()) == pytest.approx(3.0)
