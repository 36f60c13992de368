"""2D images through the port: the [1, Y, X] lift at block (1, 128, 128).

The port's ``analyze`` on 2D images is held against the JAX package's
``analyze`` (the blocked engine on the CPU) and its ``analyze_stack_pallas``
(kernel-v1 in interpret mode, the TPU kernel that carries 2D), field by
field. Tolerance: exact (every field is an integer or a boolean).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.engine import analyze as jax_analyze  # noqa: E402
from tissue_analysis_tpu.engine import analyze_stack_pallas  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK  # noqa: E402

FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def _ragged():
    return voronoi_stack((130, 260), 70, seed=4, voxelsize=(0.5, 2.0))


def _no_background():
    img = np.asarray(voronoi_stack((64, 72), 25, seed=8)).copy()
    img[img == 1] = 2  # the background label 1 is absent
    return img


# name -> (image factory or conftest fixture name, background)
IMAGES = {
    "small2d": ("small2d", 1),
    "ragged-130x260": (_ragged, 1),
    "absent-background": (_no_background, 1),
}


def assert_tables_equal(ref, port):
    assert ref.shape == port.shape
    assert ref.voxelsize == port.voxelsize
    assert ref.background_segment == port.background_segment
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def tables(request):
    cache = {}

    def get(name):
        if name not in cache:
            src, bg = IMAGES[name]
            img = request.getfixturevalue(src) if isinstance(src, str) else src()
            port = engine.analyze(img, background=bg, device="cpu")
            assert port.ndim == 2 and port.n_pairs > 0
            cache[name] = (img, bg, port)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(IMAGES))
def test_2d_equals_jax_analyze(tables, name):
    img, bg, port = tables(name)
    assert_tables_equal(jax_analyze(img, background=bg), port)


@pytest.mark.parametrize("name", list(IMAGES))
def test_2d_equals_jax_kernel_v1(tables, name):
    img, bg, port = tables(name)
    ref = analyze_stack_pallas(JaxStack.from_array(img, background=bg))
    assert_tables_equal(ref, port)


def test_absent_background_has_no_background_segment(tables):
    _, _, port = tables("absent-background")
    assert port.background_segment is None and 1 not in port.ids


def test_2d_lift_is_a_view():
    st = LabeledStack.from_array(np.arange(12, dtype=np.uint8).reshape(3, 4), device="cpu")
    lifted = engine._lift_2d(st)
    assert lifted.shape == (1, 3, 4) and lifted.voxelsize == (1.0, 1.0, 1.0)
    assert lifted.dense.data_ptr() == st.dense.data_ptr()
    assert lifted.dense.is_contiguous()


def test_converged_dict_size_keyed_by_block(monkeypatch):
    """A lifted 2D image (block (1, 128, 128)) and the same pixels as a
    [1, Y, X] stack (default block) share shape and label count but not the
    converged dictionary size: the named block engine reruns the 2D sweep
    to L = 64 and starts the 3D one at 32; ``auto`` counts and sweeps each
    once at its own size."""
    img = np.asarray(voronoi_stack((128, 128), 60, seed=2))
    st2 = LabeledStack.from_array(img, background=1, device="cpu")
    st3 = LabeledStack.from_array(img[None], background=1, device="cpu")
    for block in (engine.BLOCK_2D, DEFAULT_BLOCK):
        engine._GOOD_L.pop(((1, 128, 128), st2.n_labels, block, 32), None)
    calls = []
    real = engine.block_sweep_reference

    def recording(dense, n, block, L):
        calls.append((tuple(block), L))
        return real(dense, n, block, L)

    monkeypatch.setattr(engine, "block_sweep_reference", recording)
    t2 = engine.analyze_stack(st2, "torch")
    assert calls == [(engine.BLOCK_2D, 32), (engine.BLOCK_2D, 64)]
    calls.clear()
    t3 = engine.analyze_stack(st3, "torch")
    assert calls == [(DEFAULT_BLOCK, 32)]
    calls.clear()
    assert_tables_equal(t2, engine.analyze_stack(st2))
    assert_tables_equal(t3, engine.analyze_stack(st3))
    assert calls == [(engine.BLOCK_2D, 64), (DEFAULT_BLOCK, 32)]
    calls.clear()
    for block in (engine.BLOCK_2D, DEFAULT_BLOCK):
        engine._GOOD_L.pop(((1, 128, 128), st2.n_labels, block, 32), None)
    assert_tables_equal(t3, engine.analyze_stack(st3))
    assert_tables_equal(t2, engine.analyze_stack(st2))
    assert calls == [(DEFAULT_BLOCK, 32), (engine.BLOCK_2D, 64)]
    np.testing.assert_array_equal(t2.count, t3.count)
    np.testing.assert_array_equal(t2.wall_face_counts, t3.wall_face_counts[:, 1:])
