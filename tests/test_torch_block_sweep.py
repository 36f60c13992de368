"""Port's per-block sweep (plain version) vs the JAX package's TPU kernels.

``tissue_analysis_tpu_torch.ops.block_sweep.block_sweep_reference`` is held
block by block against both kernels of ``tissue_analysis_tpu.ops.pallas_block``
run in interpret mode on the CPU (as the JAX package's own tests run them):
kernel-v2 on the default block with n < 2¹⁶, and kernel-v1 (K2) on a lifted
2D image at block (1, 128, 128), on a 3D stack at block (4, 8, 32), and on a
label space with n ≥ 2¹⁶. v1's local moments are globalized as the JAX
engine does (``_reconstruct_rows``). The TPU kernels' slot order is
arbitrary, so their slots are put in ascending id order first. Tolerance:
exact (every output is an integer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.ops.blocked import _pad_to_blocks, _split_rows  # noqa: E402
from tissue_analysis_tpu.ops.pallas_block import (  # noqa: E402
    PallasConfig,
    _block_offsets_np,
    _check_static_pallas,
    _pallas_main_pass,
    _reconstruct_rows,
    _v2_eligible,
    assemble_moments_pallas,
)
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import (  # noqa: E402
    IMAX,
    block_sweep,
    block_sweep_reference,
)
from tissue_analysis_tpu_torch.ops.sweep_cases import CASES as SWEEP_CASES  # noqa: E402

BLOCK = (8, 16, 128)


def _stack(shape, ncells, seed):
    img = voronoi_stack(shape, ncells, seed=seed, voxelsize=(2.0, 0.5, 0.5))
    return LabeledStack.from_array(img, background=1, device="cpu")


def _port_layout(ids, cols, gmin, gmax, pz, py, px, dovf, L):
    """A TPU kernel's global outputs with slots in ascending id order, in
    the port's layout: (ids, mom [B, L, 10], gmin, gmax, faces [B, L, 3L],
    ovf)."""
    ids, cols, gmin, gmax, pz, py, px, dovf = (
        np.asarray(o) for o in (ids, cols, gmin, gmax, pz, py, px, dovf)
    )
    B = ids.shape[0]
    m = assemble_moments_pallas(
        cols.reshape(B * L, -1), gmin.reshape(-1, 3), gmax.reshape(-1, 3)
    )
    mom = np.concatenate([m["count"][:, None], m["s1"], m["s2"]], axis=1)
    mom = mom.reshape(B, L, 10)
    perm = np.argsort(ids, axis=1, kind="stable")
    rows = perm[:, :, None]
    faces = np.stack([
        np.concatenate([f[b][perm[b]][:, perm[b]] for f in (pz, py, px)], axis=1)
        for b in range(B)
    ])
    return (
        np.take_along_axis(ids, perm, axis=1),
        np.take_along_axis(mom, rows, axis=1),
        np.take_along_axis(gmin, rows, axis=1),
        np.take_along_axis(gmax, rows, axis=1),
        faces,
        dovf.astype(np.int32),
    )


def _jax_sweep(dense: np.ndarray, n: int, L: int):
    """Kernel-v2 (default block, n < 2¹⁶) in the port's layout."""
    padded = _pad_to_blocks(jnp.asarray(dense), n, BLOCK)
    out = _pallas_main_pass(
        padded, BLOCK, L, n, True, offs=_block_offsets_np(padded.shape, BLOCK)
    )
    return _port_layout(*out, L)


def _jax_v1_sweep(dense: np.ndarray, n: int, block, L: int):
    """Kernel-v1 (K2) in the port's layout: local lo/hi moments globalized
    by ``_reconstruct_rows`` and split as the JAX engine's slab pass does."""
    assert not _v2_eligible(block, n)
    padded = _pad_to_blocks(jnp.asarray(dense), n, block)
    wide = _check_static_pallas(
        padded.shape, n, PallasConfig(block=block, max_labels_per_block=L)
    )
    ids, mom_local, bbmin, bbmax, pz, py, px, dovf = _pallas_main_pass(
        padded, block, L, n, True
    )
    offs = jnp.asarray(_block_offsets_np(padded.shape, block))
    cols, gmin, gmax = _reconstruct_rows(mom_local, bbmin, bbmax, offs, wide)
    return _port_layout(ids, _split_rows(cols), gmin, gmax, pz, py, px, dovf, L)


CASES = {
    "16x32x256-u16": ((16, 32, 256), 60, 0, torch.uint16),
    "24x40x130-u16": ((24, 40, 130), 45, 1, torch.uint16),
    "16x32x256-i32": ((16, 32, 256), 60, 0, torch.int32),
}


@pytest.fixture(scope="module")
def sweeps(request):
    cache = {}

    def get(name, L=32):
        key = (name, L)
        if key not in cache:
            shape, ncells, seed, dtype = CASES[name]
            st = _stack(shape, ncells, seed)
            dense = st.dense.to(dtype)
            ref = block_sweep_reference(dense, st.n_labels, BLOCK, L)
            jx = _jax_sweep(dense.to(torch.int32).numpy().astype(
                np.uint16 if dtype == torch.uint16 else np.int32), st.n_labels, L)
            cache[key] = (st, dense, ref, jx)
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_tpu_kernel(sweeps, name):
    st, dense, ref, jx = sweeps(name)
    j_ids, j_mom, j_gmin, j_gmax, j_faces, j_ovf = jx
    # neither side overflowed, and the stack really has multi-label blocks
    assert not j_ovf.any() and not ref.ovf.any()
    assert (ref.ids < IMAX).sum(dim=1).max() >= 4
    assert ref.ids.shape[0] == np.prod([-(-s // b) for s, b in zip(st.shape, BLOCK)])
    np.testing.assert_array_equal(ref.ids.numpy(), j_ids)
    np.testing.assert_array_equal(ref.mom.numpy(), j_mom)
    np.testing.assert_array_equal(ref.gmin.numpy(), j_gmin)
    np.testing.assert_array_equal(ref.gmax.numpy(), j_gmax)
    np.testing.assert_array_equal(ref.faces.numpy(), j_faces)
    assert int(ref.faces.sum()) > 0


def test_output_contract(sweeps):
    st, dense, ref, _ = sweeps("24x40x130-u16")
    B = ref.ids.shape[0]
    L = ref.ids.shape[1]
    assert ref.ids.dtype == torch.int32 and ref.mom.dtype == torch.int64
    assert ref.faces.shape == (B, L, 3 * L) and ref.ovf.shape == (B,)
    # slots ascend, empty slots carry IMAX / zero moments / empty bbox
    ids = ref.ids.to(torch.int64)
    assert bool((ids[:, 1:] >= ids[:, :-1]).all())
    empty = ref.ids == IMAX
    assert bool((ref.mom[empty] == 0).all())
    assert bool((ref.gmin[empty] == IMAX).all() and (ref.gmax[empty] == -1).all())
    # diagonal of every face matrix is zero
    for d in range(3):
        diag = torch.diagonal(ref.faces[:, :, d * L:(d + 1) * L], dim1=1, dim2=2)
        assert bool((diag == 0).all())
    # every voxel lands in exactly one slot
    assert int(ref.mom[..., 0].sum()) == int(np.prod(st.shape))


def test_cpu_wrapper_runs_plain_version_without_counting(sweeps):
    st, dense, ref, _ = sweeps("24x40x130-u16")
    before = block_sweep.launches
    out = block_sweep(dense, st.n_labels)
    assert block_sweep.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_overflow_flag_keeps_smallest_labels(sweeps):
    st, dense, ref, _ = sweeps("24x40x130-u16")
    L = 4
    small = block_sweep_reference(dense, st.n_labels, BLOCK, L)
    nlab = (ref.ids < IMAX).sum(dim=1)
    assert torch.equal(small.ovf.bool(), nlab > L)
    assert bool(small.ovf.any())
    # the L smallest dictionary labels keep slots 0..L-1
    assert torch.equal(small.ids, ref.ids[:, :L])
    ok = ~small.ovf.bool()
    assert torch.equal(small.mom[ok], ref.mom[ok, :L])


@pytest.mark.parametrize(
    "bad,err",
    [
        (lambda d: d.to(torch.int64), TypeError),
        (lambda d: d[0], ValueError),
        (lambda d: d.transpose(0, 2), ValueError),
    ],
    ids=["int64", "rank2", "noncontiguous"],
)
def test_wrapper_rejects_bad_input(sweeps, bad, err):
    st, dense, _, _ = sweeps("24x40x130-u16")
    with pytest.raises(err):
        block_sweep(bad(dense), st.n_labels)


def _sparse_ids(dense: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """Segment ids 0..k-1 → distinct ids spread over 0..n-1 (int32)."""
    k = int(dense.to(torch.int32).max()) + 1
    rng = np.random.default_rng(seed)
    lut = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
    lut[-1] = n - 1  # the top of the label space is live
    return torch.from_numpy(lut)[dense.to(torch.int64)]


# K2 (kernel-v1) cases: name -> (image, block, label space n or None, dtype)
K2_CASES = {
    "2d-lift-256x384": (
        lambda: voronoi_stack((256, 384), 40, seed=5, voxelsize=(0.75, 1.25)),
        (1, 128, 128), None, torch.uint16,
    ),
    "3d-20x36x70-block4x8x32": (
        lambda: voronoi_stack((20, 36, 70), 50, seed=6),
        (4, 8, 32), None, torch.uint16,
    ),
    "16x32x256-i32-n70000": (
        lambda: voronoi_stack((16, 32, 256), 60, seed=0),
        BLOCK, 70000, torch.int32,
    ),
}


@pytest.fixture(scope="module")
def k2_sweeps():
    cache = {}

    def get(name):
        if name not in cache:
            make, block, n, dtype = K2_CASES[name]
            st = LabeledStack.from_array(make(), background=1, device="cpu")
            dense = st.dense if st.ndim == 3 else st.dense[None]
            if n is None:
                n = st.n_labels
                dense = dense.to(dtype)
            else:
                dense = _sparse_ids(dense, n, 7)
            ref = block_sweep_reference(dense.contiguous(), n, block, 32)
            np_dtype = np.uint16 if dtype == torch.uint16 else np.int32
            jx = _jax_v1_sweep(dense.to(torch.int32).numpy().astype(np_dtype), n, block, 32)
            cache[name] = (dense, n, block, ref, jx)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(K2_CASES))
def test_reference_matches_tpu_kernel_v1(k2_sweeps, name):
    dense, n, block, ref, jx = k2_sweeps(name)
    j_ids, j_mom, j_gmin, j_gmax, j_faces, j_ovf = jx
    assert not j_ovf.any() and not ref.ovf.any()
    assert (ref.ids < IMAX).sum(dim=1).max() >= 4
    assert ref.ids.shape[0] == np.prod([-(-s // b) for s, b in zip(dense.shape, block)])
    np.testing.assert_array_equal(ref.ids.numpy(), j_ids)
    np.testing.assert_array_equal(ref.mom.numpy(), j_mom)
    np.testing.assert_array_equal(ref.gmin.numpy(), j_gmin)
    np.testing.assert_array_equal(ref.gmax.numpy(), j_gmax)
    np.testing.assert_array_equal(ref.faces.numpy(), j_faces)
    assert int(ref.faces.sum()) > 0
    if n >= 1 << 16:
        assert int(ref.ids[ref.ids < IMAX].max()) >= 1 << 16


@pytest.fixture(scope="module")
def adversarial():
    cache = {}

    def get(name):
        if name not in cache:
            dense, n, block, L = SWEEP_CASES[name]()
            ref = block_sweep_reference(torch.from_numpy(dense), n, block, L)
            if block == BLOCK and _v2_eligible(block, n):
                jx = _jax_sweep(dense, n, L)
            else:
                jx = _jax_v1_sweep(dense, n, block, L)
            cache[name] = (dense, n, block, L, ref, jx)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_reference_matches_tpu_kernel_adversarial(adversarial, name):
    """The adversarial inputs of ``ops/sweep_cases.py``: the plain version
    equals the TPU kernel of their block and label range (v2 or v1). Where
    every block overflows, only the flags are defined."""
    dense, n, block, L, ref, jx = adversarial(name)
    j_ids, j_mom, j_gmin, j_gmax, j_faces, j_ovf = jx
    np.testing.assert_array_equal(ref.ovf.numpy(), j_ovf)
    nlab = (ref.ids < IMAX).sum(dim=1)
    if name == "alternate-x-over-L":
        assert bool(ref.ovf.all())
        return
    assert not ref.ovf.any()
    np.testing.assert_array_equal(ref.ids.numpy(), j_ids)
    np.testing.assert_array_equal(ref.mom.numpy(), j_mom)
    np.testing.assert_array_equal(ref.gmin.numpy(), j_gmin)
    np.testing.assert_array_equal(ref.gmax.numpy(), j_gmax)
    np.testing.assert_array_equal(ref.faces.numpy(), j_faces)
    live = int(((dense >= 0) & (dense < n)).sum())
    assert int(ref.mom[..., 0].sum()) == live
    if name == "alternate-x-at-L":
        assert bool((nlab == L).all())
    if name == "all-n":
        assert int(nlab.max()) == 0 and int(ref.faces.sum()) == 0
    if name == "single-label":
        assert bool((nlab == 1).all()) and int(ref.faces.sum()) == 0
