"""The JAX package's keywords on the port's entry points.

A call that the reference takes must not raise ``TypeError`` in the port:
``max_pairs`` (accepted and ignored: the port's pair tables have the size
of their content), ``chunk`` (the flat engine's chunk of voxels) and
``block_config`` / ``cfg`` (None only: the port has no block configs). They
are keywords only, so the port's positional order stays. Each call's table
equals the same call's without them, and the JAX package's table.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

import tissue_analysis_tpu.engine as jax_engine  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu_torch import engine, streaming  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.parallel import sharded  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img():
    return np.asarray(voronoi_stack((20, 33, 70), 40, seed=1))


def _stack(img):
    return LabeledStack.from_array(img, background=1, device="cpu")


def _mesh():
    return sharded.make_mesh(2, device="cpu")


# entry point -> (call with the reference's keywords, call without them)
CALLS = {
    "analyze": (
        lambda img: engine.analyze(img, background=1, device="cpu", max_pairs=7),
        lambda img: engine.analyze(img, background=1, device="cpu"),
    ),
    "analyze_stack": (
        lambda img: engine.analyze_stack(_stack(img), max_pairs=7, chunk=999,
                                         block_config=None),
        lambda img: engine.analyze_stack(_stack(img)),
    ),
    "analyze_stack chunked": (
        lambda img: engine.analyze_stack(_stack(img), engine="chunked", max_pairs=7,
                                         chunk=999),
        lambda img: engine.analyze_stack(_stack(img), engine="chunked"),
    ),
    "analyze_streamed": (
        lambda img: streaming.analyze_streamed(img, background=1, slab_z=8, device="cpu",
                                               cfg=None),
        lambda img: streaming.analyze_streamed(img, background=1, slab_z=8, device="cpu"),
    ),
    "analyze_sharded": (
        lambda img: sharded.analyze_sharded(_stack(img), _mesh(), max_pairs=7, chunk=999),
        lambda img: sharded.analyze_sharded(_stack(img), _mesh()),
    ),
    "analyze_sharded chunked": (
        lambda img: sharded.analyze_sharded(_stack(img), _mesh(), engine="chunked",
                                            max_pairs=7, chunk=999),
        lambda img: sharded.analyze_sharded(_stack(img), _mesh(), engine="chunked"),
    ),
    "analyze_sharded_pallas": (
        lambda img: sharded.analyze_sharded_pallas(_stack(img), _mesh(), cfg=None),
        None,  # the kernel engine needs a CUDA stack: the keyword is taken first
    ),
    "analyze_sharded_blocked": (
        lambda img: sharded.analyze_sharded_blocked(_stack(img), _mesh(), cfg=None),
        lambda img: sharded.analyze_sharded_blocked(_stack(img), _mesh()),
    ),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_reference_keywords_are_accepted(img, name):
    with_kw, without = CALLS[name]
    if without is None:
        with pytest.raises(ValueError, match="cuda"):
            with_kw(img)
        return
    ref = jax_engine.analyze_stack_chunked(JaxStack.from_array(img, background=1))
    got = with_kw(img)
    assert_tables_equal(without(img), got)
    assert_tables_equal(ref, got)


def test_configs_other_than_none_raise(img):
    st = _stack(img)
    for call in (
        lambda: engine.analyze_stack(st, block_config=object()),
        lambda: streaming.analyze_streamed(img, device="cpu", cfg=object()),
        lambda: sharded.analyze_sharded_pallas(st, _mesh(), cfg=object()),
        lambda: sharded.analyze_sharded_blocked(st, _mesh(), cfg=object()),
    ):
        with pytest.raises(ValueError, match="cfg=None"):
            call()
