"""The vision model zoo of mxnet_tpu_torch held against mxnet_tpu's.

- All 34 names of the reference's ``get_model``: the same parameter
  names, in order (relative to the outermost block's prefix); an unknown
  name raises ``ValueError``.
- One net per family, initialized by the port (He's init, ``HE``, from
  a seeded ``RandomState``, so the signal reaches the head: at Xavier's
  MobileNet's logits sink to 1e-20; shapes resolved by its first
  forward) and loaded into the reference's net from the port's
  ``.params`` file, one seeded batch through both.
  - Float32: the feature map ahead of the global pool and the logits in
    predict mode, and the loss, within 1e-4 of their own largest
    magnitude (no floor); after one Gluon SGD+momentum step every
    parameter and moving statistic within 5e-6 of the largest move the
    reference's step made in any array, plus 2 ulps of the weight
    (``F32_STEP_TOL`` names the two families where float32 resolves
    less, and why).  resnet18_v2 and the cut densenet121 step in train
    mode, at inputs whose last maps are at least 4 x 4; the others in
    predict mode (``autograd.record(train_mode=False)``): the families
    with Dropout (alexnet, vgg, squeezenet, inception) because the port
    draws its masks from its own generator, the MobileNets because the
    reference's float32 BatchNorm leaves its own train-mode step up to
    7e-3 of the largest move from the float64 one.
  - Float64, every family, against the reference with its BatchNorm's
    float32 lifted to float64 for the run (``mxnet_tpu`` untouched):
    the families without Dropout in train mode (BatchNorm on batch
    statistics, moving statistics updated), the others in predict mode;
    logits, loss and the step within 1e-10.
  Sizes, cut where the reference's CPU run would take minutes:
  resnet18_v2 at 128 x 128, squeezenet1.1 and both MobileNets at
  64 x 64, vgg11_bn at 32 x 32 and alexnet at 96 x 96 run whole;
  densenet121's fixed 7 x 7 pool and inceptionv3's fixed 8 x 8 keep
  their native 224 x 224 and 299 x 299, densenet with its body cut to
  ``DenseNet(16, 8, [2, 2, 2, 2])``, inception with its stem cut (the
  35 x 35 x 192 activations it produces are the input) and one block of
  each kind, A to E, then the native head.
- ``tools/benchmark_score`` on the CPU: one small name, images/s > 0.
- ``initializer`` drawing from a ``torch.Generator``: a seeded draw
  repeats bitwise and has Xavier's scale.

The family cases are split over files so that ``--dist loadfile``
spreads them: this file holds resnet18_v2, vgg11_bn, alexnet,
squeezenet1.1 and densenet121; ``test_torch_model_zoo_mobilenet.py``,
``test_torch_model_zoo_mobilenetv2.py`` and
``test_torch_model_zoo_inception.py`` the others, each case and limit as
here (the nets, inputs and checks: ``torch_zoo_cases.py``).  The
channels-last ResNet and ``.params`` file cases live in
``test_torch_model_zoo_layout.py``.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import gluon, initializer
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.tools import benchmark_score
from torch_zoo_cases import NAMES, _rel, check_family, check_family_f64

# the families whose cases live in this file
FAMILY_CASES = ["alexnet", "densenet121", "resnet18_v2", "squeezenet1.1",
                "vgg11_bn"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def test_get_model_covers_the_reference_names():
    import inspect
    import re
    src = inspect.getsource(jvision.get_model)
    assert sorted(re.findall(r'"([a-z0-9_.]+)": ', src)) == sorted(NAMES)
    with pytest.raises(ValueError):
        vision.get_model("resnet7_v3")


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_match_reference(name):
    kw = {"classes": 10}
    want = list(_rel(jvision.get_model(name, **kw)))
    got = list(_rel(vision.get_model(name, **kw)))
    assert got == want


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


# -- benchmark_score and the device-side initializer -------------------------
def test_benchmark_score_runs_on_the_cpu(capsys):
    out = benchmark_score.main(["--network", "squeezenet1.1",
                                "--batch-sizes", "1,2", "--image-shape",
                                "3,64,64", "--iters", "2", "--warmup", "1",
                                "--cpu"])
    assert [b for b, _ in out] == [1, 2] and all(ips > 0 for _, ips in out)
    text = capsys.readouterr().out
    assert "network: squeezenet1.1 (device: cpu" in text
    assert "batch size   2, image 3x64x64" in text
    nhwc = benchmark_score.score("resnet18_v1", 1, (3, 32, 32), iters=1,
                                 warmup=1, ctx="cpu", layout="NHWC")
    assert nhwc > 0


def test_initializer_draws_from_a_torch_generator():
    def draw(seed):
        net = gluon.nn.Conv2D(64, 3, in_channels=32)
        net.initialize(initializer.Xavier(rnd_type="gaussian"), ctx="cpu",
                       rng=torch.Generator().manual_seed(seed))
        return net.weight.tensor().detach().clone()

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    fan = (32 * 9 + 64 * 9) / 2.0
    assert abs(float(a.std()) / np.sqrt(3 / fan) - 1) < 0.05
    assert a.dtype == torch.float32 and a.device.type == "cpu"
