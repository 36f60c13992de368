"""CUDA kernel vs its plain PyTorch version, on the card.

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
