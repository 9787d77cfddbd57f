"""The odd-numbered cases of the reference's operator sweep through both
registries (forward); the even ones, the limits and the registry test are
``tests/test_torch_op_sweep.py``."""
import pytest

from test_torch_op_sweep import PORTED, check_case

HERE = PORTED[1::2]


@pytest.mark.parametrize("name,i,case", HERE,
                         ids=["%s-%d" % (n, i) for n, i, _ in HERE])
def test_forward_matches_reference(name, i, case):
    check_case(name, case)
