"""The controls on the card, at the cells' own sizes: the recognizer's own
bfloat16 path, and the EAST reference in bfloat16 in the program's place,
each on three seeds, must come out as not correct; the program, on one,
as correct. Run on a machine with a card:

    python -m pytest perfbench/tests -m cuda
"""

import pytest

from perfbench.calibrate import readings
from perfbench.tests.conftest import REPO

pytestmark = pytest.mark.cuda

R, E = "trba-full.recognize-b512", "east-r101.train-b3"


@pytest.mark.parametrize("workload,variant", [(R, "bfloat16"), (E, "reference_bf16")])
def test_the_lower_precision_control_is_not_correct(card, workload, variant):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        check, _ = readings(REPO, workload, seed, variant, 1.5, card)
        assert not check.correct, (seed, check.as_dict())


@pytest.mark.parametrize("workload", [R, E])
def test_the_program_is_correct(card, workload):
    check, _ = readings(REPO, workload, 2**31 + 104, "program", 1.5, card)
    assert check.correct, check.as_dict()
