"""The seeded RNG, the samplers and the op set of mxnet_tpu_torch on the
card (marked ``cuda``; skipped without one).  This file imports no JAX,
so it runs on the GPU host:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_random_cuda.py

The samplers of ``nd.random`` and ``_sample_*`` draw on the card and are
held to their laws (``tools.op_cases.sampler_checks``: mean and variance
within 6 standard errors, KS or chi-squared under alpha = 0.001); one
seed repeats bitwise, a state round trip too, and successive draws
differ.  One op of each reference file this slice ported runs forward
and backward on the card against the CPU through
``test_utils.check_consistency`` (``tools.op_cases.run_case``).
``chip_smoke.py`` phase 24 runs the same checks at 2^24 draws and every
case.
"""
import pytest
import torch

from mxnet_tpu_torch.tools import op_cases

ONE_PER_FILE = {}
for _case in op_cases.CASES:
    ONE_PER_FILE.setdefault(_case.file, _case)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_samplers_follow_their_laws_on_the_card(card):
    rows = op_cases.sampler_checks("cuda", n=1 << 20)
    assert len(rows) == 17


@pytest.mark.cuda
def test_seed_and_state_repeat_bitwise_on_the_card(card):
    assert all(op_cases.seed_checks("cuda").values())


@pytest.mark.cuda
@pytest.mark.parametrize("file", sorted(ONE_PER_FILE))
def test_op_on_the_card_matches_the_cpu(card, file):
    worst, arrays = op_cases.run_case(ONE_PER_FILE[file], "cuda")
    assert arrays >= 1 and worst <= op_cases.REL_TOL
