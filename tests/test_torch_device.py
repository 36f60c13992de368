"""The port's entry points run on the card unless the caller asks for the CPU.

Without a CUDA device, every entry point called without ``device`` raises
``RuntimeError`` naming ``device="cpu"``, and the same call with
``device="cpu"`` runs the plain engine. Whether this machine has a card is
decided inside each test, never at import.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.analysis import SpatialImageAnalysis  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack, resolve_device  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.series import analyze_series  # noqa: E402

_NO_CARD = 'device="cpu"'


@pytest.fixture(scope="module")
def img():
    return np.asarray(voronoi_stack((12, 16, 20), 10, seed=3))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")


# entry point -> (call without a device, the same call on the CPU)
CALLS = {
    "analyze": (
        lambda im: engine.analyze(im, background=1),
        lambda im: engine.analyze(im, background=1, device="cpu"),
    ),
    "analyze_raw": (
        lambda im: engine.analyze_raw(im, background=1),
        lambda im: engine.analyze_raw(im, background=1, device="cpu"),
    ),
    "LabeledStack.from_array": (
        lambda im: LabeledStack.from_array(im, background=1),
        lambda im: engine.analyze_stack(LabeledStack.from_array(im, background=1, device="cpu")),
    ),
    "SpatialImageAnalysis": (
        lambda im: SpatialImageAnalysis(im, background=1),
        lambda im: SpatialImageAnalysis(im, background=1, device="cpu").table(),
    ),
    "analyze_series": (
        lambda im: analyze_series([im], background=1),
        lambda im: analyze_series([im], background=1, devices=["cpu"])[0],
    ),
}


def test_resolve_device_none_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=_NO_CARD) as exc:
        resolve_device(None)
    assert "no CUDA device" in str(exc.value)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", list(CALLS))
def test_entry_point_defaults_to_the_card(no_card, img, name):
    default, on_cpu = CALLS[name]
    with pytest.raises(RuntimeError, match=_NO_CARD):
        default(img)
    table = on_cpu(img)
    assert table.n_labels > 2 and int(table.count.sum()) == img.size
