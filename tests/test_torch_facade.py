"""The port's ``SpatialImageAnalysis`` facade vs the JAX package's.

The same images (the fixtures of ``tests/test_api_facade.py``,
``test_surfacic.py``, ``test_connectivity.py`` and the helper cases of
``test_core_and_helpers.py``) go through both facades, and every query must
return the same value: same keys, same order, same types, same numbers.
Tolerance: exact. Every float is the same numpy finalize of equal integer
tables, and the 18/26-connectivity pairs are integer sets.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tissue_analysis_tpu.analysis as J  # noqa: E402
from tissue_analysis_tpu.core.synthetic import monolayer_shell  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.ops import stencil as jax_stencil  # noqa: E402
import tissue_analysis_tpu_torch.analysis as P  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.ops import stencil  # noqa: E402


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (
            isinstance(b, dict) and list(a) == list(b)
            and all(_same(a[k], b[k]) for k in a)
        )
    if isinstance(a, (tuple, list)):
        return (
            type(a) is type(b) and len(a) == len(b)
            and all(_same(x, y) for x, y in zip(a, b))
        )
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _corner_touch_image():
    """Two cubes meeting only at a corner + background elsewhere."""
    img = np.ones((8, 8, 8), dtype=np.uint8)
    img[1:4, 1:4, 1:4] = 5
    img[4:7, 4:7, 4:7] = 9
    return img


@pytest.fixture(scope="module")
def shell():
    return monolayer_shell((36, 36, 36), ncells=30, seed=3)


@pytest.fixture(scope="module")
def facades(request):
    """(JAX facade, port facade) per image, built once per module."""
    cache = {}
    kwargs = {
        "small3d": dict(background=1),
        "small2d": dict(background=1),
        "shell": dict(background=1, inside_label=2),
    }

    def get(name):
        if name not in cache:
            img = request.getfixturevalue(name)
            cache[name] = (
                J.SpatialImageAnalysis(img, **kwargs[name]),
                P.SpatialImageAnalysis(img, **kwargs[name], device="cpu"),
            )
        return cache[name]

    return get


QUERIES = [
    ("small3d", "labels", {}),
    ("small3d", "nb_labels", {}),
    ("small3d", "volume", {}),
    ("small3d", "volume", {"real": False}),
    ("small3d", "center_of_mass", {}),
    ("small3d", "center_of_mass", {"real": False}),
    ("small3d", "boundingbox", {}),
    ("small3d", "boundingbox", {"real": True}),
    ("small3d", "neighbors", {}),
    ("small3d", "neighbors", {"min_contact_area": 2.0}),
    ("small3d", "neighbors", {"connectivity": 2}),
    ("small3d", "neighbors", {"connectivity": 3, "min_contact_area": 0.5}),
    ("small3d", "L1", {}),
    ("small3d", "cells_in_image_margins", {}),
    ("small3d", "border_cells", {}),
    ("small3d", "wall_surfaces", {}),
    ("small3d", "wall_surfaces", {"real": False}),
    ("small3d", "epidermis_surface", {}),
    ("small3d", "epidermis_surface", {"real": False}),
    ("small3d", "inertia_axis", {}),
    ("small3d", "get_voxel_face_surface", {}),
    ("small3d", "neighbor_kernels", {}),
    ("small2d", "area", {}),
    ("small2d", "perimeter", {}),
    ("small2d", "perimeter", {"real": False}),
    ("small2d", "neighbors", {}),
    ("small2d", "neighbors", {"connectivity": 2}),
    ("small2d", "inertia_axis", {}),
    ("small2d", "L1", {}),
    ("small2d", "border_cells", {}),
    ("small2d", "wall_surfaces", {}),
    ("small2d", "epidermis_surface", {}),
    ("shell", "labels", {}),
    ("shell", "neighbors", {}),
    ("shell", "L1", {}),
    ("shell", "basal_surface", {}),
    ("shell", "basal_surface", {"real": False}),
    ("shell", "area", {}),
    ("shell", "epidermis_surface", {}),
    ("shell", "wall_surfaces", {}),
]


@pytest.mark.parametrize(
    "image,method,kwargs", QUERIES,
    ids=[f"{i}-{m}-{'-'.join(f'{k}={v}' for k, v in kw.items())}".rstrip("-")
         for i, m, kw in QUERIES],
)
def test_query_equals_jax_facade(facades, image, method, kwargs):
    ref, port = facades(image)
    assert type(port).__name__ == type(ref).__name__
    a = getattr(ref, method)(**kwargs)
    b = getattr(port, method)(**kwargs)
    assert _same(a, b), (a, b)


def test_return_modes_and_scalar_requests(small3d):
    for mode in (P.DICT, P.LIST, P.NPLIST):
        ref = J.SpatialImageAnalysis(small3d, return_type=mode, background=1)
        port = P.SpatialImageAnalysis(small3d, return_type=mode, background=1, device="cpu")
        assert _same(ref.volume(), port.volume())
        assert _same(ref.boundingbox(), port.boundingbox())
        l = port.labels()[2]
        assert _same(ref.volume(l), port.volume(l))
        assert _same(ref.center_of_mass(l), port.center_of_mass(l))
        assert port.boundingbox(999999) is None


def test_ignoredlabels(small3d):
    a = P.SpatialImageAnalysis(small3d, background=1, device="cpu")
    cell = a.L1()[0]
    victims = [l for l in a.neighbors(cell) if l != 1][:2]
    ref = J.SpatialImageAnalysis(small3d, ignoredlabels=victims, background=1)
    port = P.SpatialImageAnalysis(small3d, ignoredlabels=victims, background=1, device="cpu")
    for q in ("labels", "neighbors", "wall_surfaces", "L1", "border_cells"):
        assert _same(getattr(ref, q)(), getattr(port, q)()), q
    assert victims[0] not in port.neighbors(cell) and 1 in port.neighbors(cell)


def test_remove_margins_cells(small3d):
    ref = J.SpatialImageAnalysis(small3d, background=1)
    port = P.SpatialImageAnalysis(small3d, background=1, device="cpu")
    assert port.remove_margins_cells() == ref.remove_margins_cells()
    assert _same(ref.labels(), port.labels())
    assert _same(ref.volume(real=False), port.volume(real=False))
    assert _same(ref.neighbors(), port.neighbors())


def test_wall_voxels_between_two_cells(facades):
    ref, port = facades("small3d")
    l1, l2 = next(p for p in port.table().pair_area_map() if p[0] != 1)
    a = ref.wall_voxels_between_two_cells(l1, l2)
    b = port.wall_voxels_between_two_cells(l1, l2)
    assert b.shape[1] > 0 and _same(a, b)


@pytest.mark.parametrize("conn", [1, 2, 3])
def test_corner_touch_connectivity(conn):
    img = _corner_touch_image()
    ref = J.SpatialImageAnalysis(img, background=1)
    port = P.SpatialImageAnalysis(img, background=1, device="cpu")
    got = port.neighbors(connectivity=conn)
    assert _same(ref.neighbors(connectivity=conn), got)
    assert (9 in got[5]) == (conn == 3)
    a = ref.neighbors(5, connectivity=conn, min_contact_area=0.5)
    b = port.neighbors(5, connectivity=conn, min_contact_area=0.5)
    assert _same(a, b) and 9 not in b and 1 in b


@pytest.mark.parametrize("conn", [1, 2, 3])
def test_voronoi_connectivity(conn):
    img = voronoi_stack((24, 24, 24), 20, seed=3, voxelsize=(2.0, 0.5, 0.5))
    ref = J.SpatialImageAnalysis(np.asarray(img), background=1)
    port = P.SpatialImageAnalysis(np.asarray(img), background=1, device="cpu")
    assert _same(ref.neighbors(connectivity=conn), port.neighbors(connectivity=conn))


@pytest.mark.parametrize("ndim,conn", [(2, 1), (2, 2), (3, 1), (3, 2), (3, 3)])
def test_adjacency_offsets_equal_jax(small3d, small2d, ndim, conn):
    img = small3d if ndim == 3 else small2d
    offs = stencil.connectivity_offsets(ndim, conn)
    assert offs == jax_stencil.connectivity_offsets(ndim, conn)
    st = LabeledStack.from_array(img, background=1, device="cpu")
    plo, phi, cnt = stencil.adjacency_offsets(st.dense, st.n_labels, offs)
    import jax.numpy as jnp

    jlo, jhi, jcnt, jn = jax_stencil.adjacency_offsets(
        jnp.asarray(st.dense.to(torch.int32).numpy()), st.n_labels, offs, 4096
    )
    jn = int(jn)
    assert jn <= 4096 and plo.shape[0] == jn
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo)[:jn])
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi)[:jn])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt)[:jn])


def test_hollow_out_cells(small3d):
    a = J.hollow_out_cells(small3d, background=1)
    b = P.hollow_out_cells(small3d, background=1, device="cpu")
    assert _same(np.asarray(a), np.asarray(b))
    assert b.voxelsize == a.voxelsize
    assert int((np.asarray(b) != np.asarray(small3d)).sum()) > 0


@pytest.mark.parametrize("image,label", [("cube", 5), ("small3d", 7), ("small2d", 4)])
def test_wall(request, image, label):
    img = np.asarray(request.getfixturevalue(image))
    m = P.wall(img, label, device="cpu")
    assert m.any() and _same(J.wall(img, label), m)


def test_small_helpers(small3d):
    sl = (slice(2, 5), slice(0, 3))
    for f, args in (
        ("dilation", (sl,)),
        ("dilation_by", (sl, 2, (6, 4))),
        ("distance", ((0, 0, 0), (3, 4, 0))),
    ):
        assert _same(getattr(J, f)(*args), getattr(P, f)(*args)), f
    bbs = J.SpatialImageAnalysis(small3d, background=1).boundingbox()
    assert J.sort_boundingbox(bbs) == P.sort_boundingbox(bbs)
    assert J.sort_boundingbox(bbs, reverse=False) == P.sort_boundingbox(bbs, reverse=False)


def test_misc_utilities(tmp_path):
    from tissue_analysis_tpu.core.spatial_image import SpatialImage as JImage
    from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage as PImage

    arr = np.array([[1, 2, 2], [3, 3, 9]], dtype=np.uint8)
    ji, pi = JImage(arr, voxelsize=(0.5, 2.0)), PImage(arr, voxelsize=(0.5, 2.0))
    assert P.labels_in_image(pi, exclude=[1]) == J.labels_in_image(ji, exclude=[1])
    for a, b in (
        (J.relabel_image(ji, {2: 7, 9: 2}), P.relabel_image(pi, {2: 7, 9: 2})),
        (J.relabel_image(ji, {2: 7}, default=0), P.relabel_image(pi, {2: 7}, default=0)),
        (J.remove_cells(ji, [2, 9]), P.remove_cells(pi, [2, 9])),
    ):
        assert isinstance(b, PImage) and b.voxelsize == a.voxelsize
        assert _same(np.asarray(a), np.asarray(b))
    p = str(tmp_path / "labels.txt")
    P.save_labels([3, 9], p)
    assert J.load_labels(p) == P.load_labels(p) == [3, 9]


def test_factory_dispatch(small3d, small2d):
    assert isinstance(P.SpatialImageAnalysis(small3d, device="cpu"), P.SpatialImageAnalysis3D)
    assert isinstance(P.SpatialImageAnalysis(small2d, device="cpu"), P.SpatialImageAnalysis2D)
    thin = np.ones((2, 16, 16), dtype=np.uint8)
    assert isinstance(P.SpatialImageAnalysis(thin, device="cpu"), P.SpatialImageAnalysis3DS)
    assert isinstance(
        P.SpatialImageAnalysis(np.asarray(small3d), variant="3DS", device="cpu"),
        P.SpatialImageAnalysis3DS,
    )
    with pytest.raises(ValueError):
        P.SpatialImageAnalysis(np.ones((2, 2, 2, 2), np.uint8), device="cpu")


def test_analysis_config_and_background_override(small3d):
    img = np.asarray(small3d)
    cfg = P.AnalysisConfig(background=1, ignoredlabels=(3,), return_type=P.LIST)
    a = P.SpatialImageAnalysis(img, config=cfg, device="cpu")
    assert 3 not in a.labels() and isinstance(a.volume(), list)
    b = P.SpatialImageAnalysis(img, config=cfg, return_type=0, device="cpu")
    assert isinstance(b.volume(), dict)
    cfg7 = P.AnalysisConfig(background=7)
    assert P.SpatialImageAnalysis(img, background=1, config=cfg7, device="cpu").background() == 1
    assert P.SpatialImageAnalysis(img, config=cfg7, device="cpu").background() == 7


@pytest.mark.parametrize(
    "name,port_engine",
    [("auto", "auto"), ("cuda", "cuda"), ("torch", "torch"),
     ("pallas", "cuda"), ("blocked", "torch"), ("chunked", "torch")],
)
def test_engine_name_mapping(facades, small3d, name, port_engine):
    assert P.resolve_engine(name) == port_engine
    a = P.SpatialImageAnalysis(small3d, config=P.AnalysisConfig(engine=name), device="cpu")
    if port_engine == "cuda":
        # the kernel needs a CUDA stack: a CPU stack raises, never falls back
        with pytest.raises(ValueError, match="cuda"):
            a.table()
    else:
        ref, _ = facades("small3d")
        assert _same(ref.volume(), a.volume())


def test_unknown_engine_and_missing_cuda_raise(small3d, monkeypatch):
    a = P.SpatialImageAnalysis(small3d, config=P.AnalysisConfig(engine="xla"), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        a.table()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.SpatialImageAnalysis(small3d, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        P.hollow_out_cells(small3d, background=1, device="cuda")
