"""The odd-numbered gradient cases of the reference's operator sweep
through both registries; the even ones and the limits are
``tests/test_torch_op_sweep_grad.py``."""
import pytest

from test_torch_op_sweep_grad import GRAD_CASES, check_case

HERE = GRAD_CASES[1::2]


@pytest.mark.parametrize("name,i,case", HERE,
                         ids=["%s-%d" % (n, i) for n, i, _ in HERE])
def test_gradient_matches_reference(name, i, case):
    check_case(name, case)
