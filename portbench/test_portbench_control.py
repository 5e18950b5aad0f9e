"""The control comes out not correct through the comparison a run uses:
``calibrate.calibrate`` judges the program and the control (the reference
put in the program's place in TF32; on the CPU each product's operands
rounded to TF32's mantissa) by ``harness.judge.verdict`` against the
cell's own limits. At a size a test run holds: widths of 128, a
vocabulary of 4096 and some thousands of served positions (the widest gap
needs positions where the top two logits lie within TF32's error), with a
limit set from this size's readings. On the card ``calibrate.py`` reads
both at the cells' own sizes against their limits."""
from __future__ import annotations

import pytest

from calibrate import calibrate
from conftest import tiny_cell

LIMIT = 1e-4


def _cell(kind: str):
    cell = tiny_cell(kind, sample=64, limit=LIMIT)
    cell.config.update(d_model=128, vocab_size=4096, d_ff=256)
    if kind == "adopted":
        cell.traffic["adopted"].update(requests=8, max_new=300)
        cell.cell["engine"].update(n_slots=8, n_pages=512, max_context=500)
    else:
        cell.traffic["closed"].update(
            clients=16, stagger_first=False,
            output={"dist": "uniform", "lo": 80, "hi": 120})
        cell.cell["engine"].update(n_slots=16, n_pages=512, max_context=200)
    return cell


@pytest.mark.parametrize("kind,seed", [("adopted", 2 ** 31 + 41),
                                       ("adopted", 2 ** 31 + 42),
                                       ("adopted", 2 ** 31 + 43),
                                       ("closed", 2 ** 31 + 44)])
def test_control_fails_where_the_program_passes(kind, seed, cpu_threads):
    [row] = calibrate(_cell(kind), [seed],
                      5.0 if kind == "adopted" else 10.0, device="cpu")
    program, control = row["program"], row["control"]
    assert program["checks"]["positions"]["value"] >= 1000, row
    assert program["correct"], row
    assert not control["correct"], row
    assert control["checks"]["logit_gap"]["value"] > \
        control["checks"]["logit_gap"]["limit"] == LIMIT, row
