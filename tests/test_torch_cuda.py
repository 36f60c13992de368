"""CUDA kernel vs its plain PyTorch version, and the card vs the CPU.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (and nvcc), run them without the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The plain version is held against the JAX package's kernel on the CPU by
``test_torch_block_sweep.py``; here the kernel must equal the plain version
exactly (``torch.equal``), on every block that did not overflow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import (  # noqa: E402
    block_sweep,
    block_sweep_reference,
    max_dict_size,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _stack(shape, ncells, seed, device):
    img = voronoi_stack(shape, ncells, seed=seed)
    return LabeledStack.from_array(img, background=1, device=device)


def _assert_sweeps_equal(k, r):
    assert torch.equal(k.ovf, r.ovf)
    ok = ~r.ovf.bool()
    for name in ("ids", "mom", "gmin", "gmax", "faces"):
        a, b = getattr(k, name), getattr(r, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a[ok], b[ok]), name


@pytest.mark.parametrize(
    "shape,ncells,dtype,block,L",
    [
        ((64, 64, 64), 150, torch.uint16, (8, 16, 128), 32),
        ((24, 40, 130), 45, torch.uint16, (8, 16, 128), 32),
        ((16, 32, 256), 60, torch.int32, (8, 16, 128), 32),
        ((20, 36, 70), 80, torch.uint16, (4, 8, 32), 16),
        ((3, 130, 140), 40, torch.int32, (1, 128, 128), 32),
        ((32, 48, 130), 200, torch.uint16, (8, 16, 128), 8),  # overflows
    ],
)
def test_kernel_equals_plain_version(dev, shape, ncells, dtype, block, L):
    st = _stack(shape, ncells, 0, dev)
    dense = st.dense.to(dtype)
    before = block_sweep.launches
    k = block_sweep(dense, st.n_labels, block, L)
    torch.cuda.synchronize()
    assert block_sweep.launches == before + 1
    r = block_sweep_reference(dense, st.n_labels, block, L)
    _assert_sweeps_equal(k, r)
    if L == 8:
        assert bool(k.ovf.any())


def test_engine_cuda_equals_cpu(dev):
    img = voronoi_stack((40, 48, 136), 90, seed=4, voxelsize=(2.0, 0.5, 0.5))
    cpu = engine.analyze_stack(LabeledStack.from_array(img, background=1))
    before = block_sweep.launches
    gpu = engine.analyze_stack(LabeledStack.from_array(img, background=1, device=dev))
    assert block_sweep.launches > before
    for f in ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


def test_engine_cuda_beyond_uint16_labels(dev):
    """65,536 labels (int32 stack) through the kernel, with the dictionary
    retry (82 labels per block: L 32 → 64 → 128), equal to the plain engine."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    img = grid_stack((256, 256, 512), (8, 8, 8))
    st = LabeledStack.from_array(img, background=None, device=dev)
    assert st.n_labels == 65536 and st.dense.dtype == torch.int32
    before = block_sweep.launches
    gpu = engine.analyze_stack(st)
    assert block_sweep.launches - before == 3
    plain = engine.analyze_stack(st, engine="torch")
    for f in ("count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(gpu, f), err_msg=f)
    assert np.all(gpu.count == 512)


def test_dict_size_beyond_shared_memory_raises(dev):
    st = _stack((8, 16, 128), 10, 0, dev)
    with pytest.raises(ValueError, match="shared-memory"):
        block_sweep(st.dense, st.n_labels, L=max_dict_size() + 1)


def _sparse_ids(dense, n, seed):
    """Segment ids 0..k-1 → distinct ids spread over 0..n-1 (int32)."""
    k = int(dense.to(torch.int32).max()) + 1
    lut = np.sort(np.random.default_rng(seed).choice(n, size=k, replace=False))
    lut[-1] = n - 1
    return torch.from_numpy(lut.astype(np.int32)).to(dense.device)[dense.to(torch.int64)]


@pytest.mark.parametrize(
    "shape,ncells,block",
    [((16, 32, 256), 60, (8, 16, 128)), ((1, 300, 520), 50, (1, 128, 128))],
)
def test_kernel_equals_plain_version_label_space_past_uint16(dev, shape, ncells, block):
    """K2's label range: ids spread over n = 70,000 (int32)."""
    st = _stack(shape, ncells, 0, dev)
    dense = _sparse_ids(st.dense, 70000, 3).contiguous()
    k = block_sweep(dense, 70000, block, 32)
    torch.cuda.synchronize()
    r = block_sweep_reference(dense, 70000, block, 32)
    _assert_sweeps_equal(k, r)
    assert not bool(k.ovf.any())


def test_kernel_equals_plain_version_at_L128(dev):
    """A dense grid (8³ cells: 82 labels per default block) at L = 128,
    the largest dictionary the kernel's shared memory holds."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    st = LabeledStack.from_array(grid_stack((64, 128, 256), (8, 8, 8)), device=dev)
    dense = st.dense.to(torch.int32)
    assert max_dict_size() >= 128
    k = block_sweep(dense, st.n_labels, (8, 16, 128), 128)
    torch.cuda.synchronize()
    r = block_sweep_reference(dense, st.n_labels, (8, 16, 128), 128)
    _assert_sweeps_equal(k, r)
    assert not bool(k.ovf.any())
    assert int((r.ids < 2**31 - 1).sum(dim=1).max()) == 82


FIELDS = ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
          "wall_face_counts", "margin")


def test_2d_cuda_equals_cpu(dev):
    img = voronoi_stack((600, 700), 120, seed=2, voxelsize=(0.5, 2.0))
    cpu = engine.analyze(img, background=1)
    before = block_sweep.launches
    gpu = engine.analyze(img, background=1, device=dev)
    assert block_sweep.launches > before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int64])
def test_analyze_raw_cuda_equals_cpu(dev, dtype):
    img = np.asarray(voronoi_stack((40, 48, 136), 90, seed=4)).astype(dtype)
    cpu = engine.analyze(img, background=1)
    before = block_sweep.launches
    gpu = engine.analyze_raw(img, background=1, device=dev)
    assert block_sweep.launches > before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


@pytest.mark.parametrize("shape,ncells", [((40, 48, 72), 60), ((300, 340), 60)])
def test_facade_cuda_equals_cpu(dev, shape, ncells):
    from tissue_analysis_tpu_torch.analysis import SpatialImageAnalysis, hollow_out_cells

    img = voronoi_stack(shape, ncells, seed=5)
    cpu = SpatialImageAnalysis(img, background=1)
    gpu = SpatialImageAnalysis(img, background=1, device=dev)
    assert gpu.stack().device.type == "cuda"
    before = block_sweep.launches
    for q, kw in (("volume", {}), ("neighbors", {}), ("L1", {}),
                  ("border_cells", {}), ("wall_surfaces", {}),
                  ("neighbors", {"connectivity": len(shape)})):
        assert getattr(cpu, q)(**kw) == getattr(gpu, q)(**kw), q
    assert block_sweep.launches > before
    for l, (vecs, vals) in cpu.inertia_axis().items():
        g_vecs, g_vals = gpu.inertia_axis()[l]
        np.testing.assert_array_equal(vecs, g_vecs)
        np.testing.assert_array_equal(vals, g_vals)
    np.testing.assert_array_equal(
        np.asarray(hollow_out_cells(img, 1)), np.asarray(hollow_out_cells(img, 1, device=dev))
    )
