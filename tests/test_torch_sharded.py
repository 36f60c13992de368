"""Port's ``parallel/sharded.py`` vs the JAX package's sharded engines.

The same stacks go through the JAX package's z-slab-sharded engines, on the
8-device CPU mesh that ``conftest.py`` sets up, and through the port's
``analyze_sharded`` on a CPU mesh of as many entries; every FeatureTable
field must agree exactly (atol 0: all fields are integers or booleans), and
equal the port's resident ``analyze_stack`` table too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tissue_analysis_tpu.parallel.sharded import (  # noqa: E402
    analyze_sharded_blocked as jax_sharded_blocked,
    analyze_sharded_chunked as jax_sharded_chunked,
    analyze_sharded_pallas as jax_sharded_pallas,
)
from tissue_analysis_tpu_torch import engine, streaming  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.ops import combine  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK, IMAX  # noqa: E402
from tissue_analysis_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    analyze_sharded,
    analyze_sharded_blocked,
    analyze_sharded_chunked,
    analyze_sharded_pallas,
    make_mesh,
)
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacks(img, background=1):
    return (
        JaxStack.from_array(img, voxelsize=img.voxelsize, background=background),
        LabeledStack.from_array(img, voxelsize=img.voxelsize, background=background,
                                device="cpu"),
    )


def _port(stack, k, **kw):
    """The port's sharded table on a k-entry CPU mesh, held against its
    resident table."""
    got = analyze_sharded(stack, make_mesh(k, device="cpu"), **kw)
    assert_tables_equal(engine.analyze_stack(stack), got)
    return got


# test_sharding.py's blocked cases
@pytest.mark.parametrize(
    "shape,ncells,seed,ndev",
    [
        ((32, 32, 32), 40, 0, 8),
        ((30, 24, 28), 30, 1, 8),  # depth not a multiple of ndev·8: ragged slabs
        ((5, 16, 16), 6, 2, 8),  # fewer planes than devices: one slab
        ((64, 48, 40), 80, 3, 4),
    ],
)
def test_sharded_equals_jax_sharded_blocked(shape, ncells, seed, ndev):
    img = voronoi_stack(shape, ncells, seed=seed, voxelsize=(2.0, 0.5, 0.5))
    js, ps = _stacks(img)
    ref = jax_sharded_blocked(js, mesh=jax_make_mesh(ndev))
    assert_tables_equal(ref, _port(ps, ndev))
    assert_tables_equal(ref, analyze_sharded_blocked(ps, make_mesh(ndev, device="cpu")))


def test_sharded_equals_jax_sharded_pallas():
    img = voronoi_stack((30, 24, 28), 30, seed=1, voxelsize=(2.0, 0.5, 0.5))
    js, ps = _stacks(img)
    ref = jax_sharded_pallas(js, mesh=jax_make_mesh(4))  # interpret mode on the CPU
    assert_tables_equal(ref, _port(ps, 4))


def test_sharded_2d_equals_jax_sharded_chunked():
    """A 2D image is split along y: 300 rows on 4 devices give slabs of
    128, 128 and 44 rows, and two y-seams whose faces are axis 0's."""
    img = voronoi_stack((300, 80), 40, seed=6, voxelsize=(0.5, 2.0))
    js, ps = _stacks(img)
    ref = jax_sharded_chunked(js, mesh=jax_make_mesh(4))
    with timing.collect() as t:
        got = _port(ps, 4)
    assert sum(s.name == "shard: shift + z-seam" for s in t.stages) == 3
    assert_tables_equal(ref, got)
    assert got.wall_face_counts.shape == (got.n_pairs, 2)
    assert_tables_equal(ref, analyze_sharded_chunked(ps, make_mesh(4, device="cpu")))


@pytest.mark.parametrize("k,slabs", [(1, 1), (2, 2), (4, 3)])
def test_mesh_sizes_equal_resident(k, slabs):
    """Depth 36: slabs of 40, 24 and 16 planes (multiples of the block's 8)."""
    img = voronoi_stack((36, 40, 70), 60, seed=5, voxelsize=(1.5, 0.5, 0.25))
    _, ps = _stacks(img)
    with timing.collect() as t:
        _port(ps, k)
    assert sum(s.name == "shard: shift + z-seam" for s in t.stages) == slabs


def test_only_one_slab_overflows():
    """Four slabs of one 8×16×128 block each; only the third holds more
    than 32 dictionary labels (64 cells of 8×4×8). It alone reruns, at
    L = 64; the next call starts every slab of that shape there."""
    img = np.full((32, 16, 128), 1, np.int32)
    img[:, :, 64:] = 2
    cells = np.arange(64).reshape(1, 4, 16).repeat(8, 0).repeat(4, 1).repeat(8, 2)
    img[16:24] = 3 + cells
    st = LabeledStack.from_array(img, background=1, device="cpu")
    mesh = make_mesh(4, device="cpu")
    key = ((8, 16, 128), st.n_labels, DEFAULT_BLOCK, 32)
    engine._GOOD_L.pop(key, None)
    with timing.collect() as t:
        got = analyze_sharded(st, mesh)
    assert sum(s.name == "device sweep (block)" for s in t.stages) == 4 + 1
    assert engine._GOOD_L[key] == 64
    assert_tables_equal(engine.analyze_stack(st), got)
    with timing.collect() as t:
        again = analyze_sharded(st, mesh)
    assert sum(s.name == "device sweep (block)" for s in t.stages) == 4
    assert_tables_equal(got, again)


def test_label_space_past_uint16():
    """Segment ids spread over n = 70,000 (an int32 stack)."""
    img = np.asarray(voronoi_stack((26, 40, 70), 60, seed=2))
    small = LabeledStack.from_array(img, background=1, device="cpu")
    lut = np.sort(np.random.default_rng(3).choice(70000, small.n_labels, replace=False))
    lut[-1] = 69999
    dense = lut.astype(np.int32)[small.dense.to(torch.int64).numpy()]
    st = LabeledStack.from_numpy(dense, np.arange(70000), (1.0,) * 3, None, device="cpu")
    assert st.dense.dtype == torch.int32
    got = _port(st, 4)
    assert got.n_labels == 70000 and int((got.count > 0).sum()) == small.n_labels


def _moments(points, n, nd):
    """Finished-layout tables of ``points`` (label → [k, nd] int64)."""
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    mom = torch.zeros((n, 1 + nd + len(pairs)), dtype=torch.int64)
    cmin = torch.full((n, nd), IMAX, dtype=torch.int32)
    cmax = torch.full((n, nd), -1, dtype=torch.int32)
    for lab, p in points.items():
        p = torch.from_numpy(p)
        mom[lab, 0] = p.shape[0]
        mom[lab, 1:1 + nd] = p.sum(0)
        mom[lab, 1 + nd:] = torch.stack([(p[:, i] * p[:, j]).sum() for i, j in pairs])
        cmin[lab], cmax[lab] = p.amin(0).int(), p.amax(0).int()
    return mom, cmin, cmax


@pytest.mark.parametrize("nd", [2, 3])
def test_shift_moments_is_exact(nd):
    """Shifting the moments of local coordinates by d along axis 0 gives
    the moments of the shifted coordinates (3D: zz, zy, zx, yy, yx, xx;
    2D: yy, yx, xx). Label 2 is absent and keeps IMAX / -1."""
    rng = np.random.default_rng(nd)
    local = {lab: rng.integers(0, 1000, (int(rng.integers(1, 40)), nd)) for lab in (0, 1, 3)}
    d = 123456789
    shifted = {lab: p + np.eye(1, nd, dtype=np.int64)[0] * d for lab, p in local.items()}
    got = combine.shift_moments(*_moments(local, 4, nd), d)
    for a, b in zip(got, _moments(shifted, 4, nd)):
        assert torch.equal(a, b)
    if nd == 3:
        # the same algebra as the streaming engine's host shift
        mom, cmin, cmax = (t.numpy().astype(np.int64) for t in _moments(local, 4, 3))
        m = {"count": mom[:, 0].copy(), "s1": mom[:, 1:4].copy(), "s2": mom[:, 4:].copy(),
             "cmin": cmin, "cmax": cmax}
        m = streaming._shift_moments_z(m, d)
        np.testing.assert_array_equal(got[0][:, 0].numpy(), m["count"])
        np.testing.assert_array_equal(got[0][:, 1:4].numpy(), m["s1"])
        np.testing.assert_array_equal(got[0][:, 4:].numpy(), m["s2"])
        np.testing.assert_array_equal(got[1].numpy(), m["cmin"])
        np.testing.assert_array_equal(got[2].numpy(), m["cmax"])


def test_mesh_and_input_errors(monkeypatch):
    img = voronoi_stack((16, 16, 16), 10, seed=0)
    _, ps = _stacks(img)
    mesh = make_mesh(4, device="cpu")
    assert mesh.shape == {"z": 4} and mesh.devices == (torch.device("cpu"),) * 4
    assert Mesh(("cpu", "cpu")).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least one"):
        Mesh(())
    with pytest.raises(ValueError, match="positive"):
        make_mesh(0, device="cpu")
    # no fallback: the kernel needs CUDA slabs
    for name in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="cuda"):
            analyze_sharded(ps, mesh, engine=name)
    with pytest.raises(ValueError, match="cuda"):
        analyze_sharded_pallas(ps, mesh)
    with pytest.raises(ValueError, match="unknown engine"):
        analyze_sharded(ps, mesh, engine="tpu")
    # the reference's input rules: pallas and blocked take 3D stacks only
    _, p2 = _stacks(voronoi_stack((20, 24), 6, seed=0))
    for fn in (analyze_sharded_pallas, analyze_sharded_blocked):
        with pytest.raises(ValueError, match="3D"):
            fn(p2, mesh)
    with pytest.raises(ValueError, match="2D or 3D"):
        analyze_sharded(LabeledStack(ps.dense[None], ps.ids, (1.0,) * 4, 0), mesh)
    # CUDA meshes: none without a card, never more cards than are visible
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        analyze_sharded(ps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1).shape == {"z": 1}
    with pytest.raises(ValueError, match="asked for 4 CUDA devices; 2 are visible"):
        make_mesh(4)
