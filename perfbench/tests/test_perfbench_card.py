"""On the card, at a cell's own size: the program is correct and its
control (the port's bfloat16 path) is not.  Skips without a card."""

import pytest

from perfbench.core import cell, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.manifest()["workloads"]])
def test_program_correct_and_control_not(cuda, workload):
    c = spec.load_cell(workload)
    assert cell.run(c, 2 ** 31 + 17, 3.0, False, "cuda")["correct"]
    assert not cell.run(c, 2 ** 31 + 17, 3.0, False, "cuda",
                        overrides={"compute_dtype": "bfloat16"})["correct"]
