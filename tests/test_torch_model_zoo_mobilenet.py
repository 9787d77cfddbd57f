"""The vision model zoo, family mobilenet1.0: the cases of
``test_torch_model_zoo.py`` for this family, in a file of its own so that
``--dist loadfile`` runs it beside the others (the nets, inputs, checks
and limits: ``torch_zoo_cases.py``).

Wall at ``-n 6``: ~310 s.
"""
import pytest

from mxnet_tpu_torch.context import use
from torch_zoo_cases import check_family, check_family_f64

FAMILY_CASES = ["mobilenet1.0"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


@pytest.mark.parametrize("name", FAMILY_CASES)
def test_family_matches_reference(name, tmp_path):
    """``torch_zoo_cases.check_family``: float32, He init, the feature
    map, logits, loss and one SGD step against the reference."""
    check_family(name, tmp_path)


@pytest.mark.parametrize("name", FAMILY_CASES)
def test_family_matches_reference_in_float64(name, tmp_path):
    """``torch_zoo_cases.check_family_f64``: float64 against the
    reference with its BatchNorm lifted to float64."""
    check_family_f64(name, tmp_path)
