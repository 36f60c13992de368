"""The port stands alone: no JAX at run time, same synthetic stacks as the
reference, and FeatureTable files that either package can read."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core import synthetic as jax_synthetic  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.engine import analyze_stack_blocked  # noqa: E402
from tissue_analysis_tpu.features.table import FeatureTable as JaxTable  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core import synthetic  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.features.table import FeatureTable  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import numpy as np
        import tissue_analysis_tpu_torch as T
        from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack

        import tissue_analysis_tpu_torch.analysis as A
        import tissue_analysis_tpu_torch.ops.stencil  # noqa: F401

        img = voronoi_stack((16, 16, 16), 12, seed=0)
        t = T.analyze(img, background=1, device="cpu")
        g = T.graph_from_table(t)
        assert t.n_labels > 2 and t.n_pairs > 0 and g.nb_edges() > 0
        assert int(t.count.sum()) == 16 ** 3
        raw = T.analyze_raw(img, background=1, device="cpu")
        assert np.array_equal(raw.count, t.count)
        a = A.SpatialImageAnalysis(voronoi_stack((24, 20), 8, seed=1), background=1,
                                   device="cpu")
        assert a.nb_labels() > 2 and len(a.neighbors(connectivity=2)) > 2
        assert A.hollow_out_cells(img, background=1, device="cpu").shape == img.shape
        import tissue_analysis_tpu_torch.graph.temporal  # noqa: F401
        import tissue_analysis_tpu_torch.ops.seam  # noqa: F401
        from tissue_analysis_tpu_torch.oracle import ScipyOracle
        assert ScipyOracle(img, background=1).volume()[1] > 0
        s = T.analyze_streamed(img, background=1, slab_z=5, device="cpu")
        assert np.array_equal(s.pair_lo, t.pair_lo) and np.array_equal(s.s2, t.s2)
        tpg = T.temporal_graph_from_images([img, img], [{2: [2]}], background=1,
                                           devices=["cpu"])
        assert tpg.graph_property("nb_time_points") == 2
        assert T.temporal_change(tpg, "volume", rank=1)
        leaked = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "tissue_analysis_tpu")
            and sys.modules[m] is not None
        )
        assert not leaked, leaked
        print("OK", t.n_labels, t.n_pairs)
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")


@pytest.mark.parametrize(
    "args",
    [
        ((24, 28, 26), 25, 3),
        ((32, 32, 32), 40, 0),
        ((48, 40), 20, 1),
    ],
    ids=["3d-24x28x26", "3d-32", "2d-48x40"],
)
def test_voronoi_stack_bit_equal(args):
    shape, ncells, seed = args
    a = jax_synthetic.voronoi_stack(shape, ncells, seed=seed)
    b = synthetic.voronoi_stack(shape, ncells, seed=seed)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.voxelsize == b.voxelsize


def test_fixture_images_bit_equal():
    for name in ("single_cube_image", "two_slab_image"):
        a = np.asarray(getattr(jax_synthetic, name)())
        b = np.asarray(getattr(synthetic, name)())
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def table_pair(small3d):
    ref = analyze_stack_blocked(JaxStack.from_array(small3d, background=1))
    port = engine.analyze_stack(LabeledStack.from_array(small3d, background=1, device="cpu"))
    return ref, port


def _assert_same_table(a, b):
    for f in FeatureTable._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.shape == b.shape
    assert a.voxelsize == b.voxelsize
    assert a.background_segment == b.background_segment


def test_npz_port_to_reference(table_pair, tmp_path):
    ref, port = table_pair
    path = str(tmp_path / "port.npz")
    port.save(path)
    _assert_same_table(ref, JaxTable.load(path))


def test_npz_reference_to_port(table_pair, tmp_path):
    ref, port = table_pair
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    loaded = FeatureTable.load(path)
    _assert_same_table(port, loaded)
    np.testing.assert_array_equal(loaded.barycenter(), port.barycenter())


@pytest.mark.parametrize("value,on", [
    ("1", True), ("true", True), ("YES", True), ("on", True),
    ("", False), ("0", False), ("false", False), ("off", False), ("no", False),
])
def test_stage_verbose_allowlist(monkeypatch, capsys, value, on):
    monkeypatch.setenv("TA_STAGE_VERBOSE", value)
    with timing.stage("probe"):
        pass
    assert ("stage: probe" in capsys.readouterr().out) == on


def test_stage_records_into_collector():
    with timing.collect() as t:
        with timing.stage("a", 1000):
            pass
        with timing.stage("b", None, torch.device("cpu")):
            pass
    assert [s.name for s in t.stages] == ["a", "b"]
    assert "total" in t.report()
