"""``engine="auto"`` sending only the blocks past a dictionary to the flat
engine, on the CPU (the plain block engine).

Each stack holds blocks of fresh labels of one voxel, past every
dictionary, among Voronoi cells. ``auto`` sweeps it by blocks at a small L
and the routed blocks flat beside it (``ops/flat_blocks.py``); its table
must equal the port's flat engine (``engine="chunked"``) and the JAX
package's ``analyze_stack_chunked`` field by field. The rule that chooses
L and the routed blocks (``engine.split_plan``) is held against count
vectors of its own.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

import tissue_analysis_tpu.engine as jax_engine  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.ops import flat_blocks, segred, stencil  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

BLOCK = (8, 16, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape, boxes, seed=4):
    """Voronoi cells over ``shape`` (2D or 3D, background 1), each box of
    ``boxes`` overwritten by fresh labels of one voxel each."""
    img = np.asarray(voronoi_stack(shape, 40, seed=seed, sphere=False)).astype(np.int64)
    base = int(img.max()) + 1
    for box in boxes:
        size = int(np.prod(img[box].shape))
        img[box] = base + np.arange(size).reshape(img[box].shape)
        base += size
    return img


def _blocks(shape, *coords):
    """z-major indices of the blocks at ``coords`` (block coordinates)."""
    gy, gx = -(-shape[1] // BLOCK[1]), -(-shape[2] // BLOCK[2])
    return [(z * gy + y) * gx + x for z, y, x in coords]


S = np.s_
# name -> (shape, dense boxes, the blocks routed). Each stack is large
# enough that the split takes fewer bytes than the flat engine over it.
CASES = {
    # the dense block and its z-, y- and x-predecessors
    "interior": ((40, 48, 384), [S[8:16, 16:32, 128:256]],
                 _blocks((40, 48, 384), (1, 1, 1), (0, 1, 1), (1, 0, 1), (1, 1, 0))),
    # 4,515 labels in a block ragged along x, 903 in the corner block, both
    # clear of the blocks' near faces
    "ragged-edge-and-corner": ((36, 56, 300), [S[9:16, 17:32, 257:300], S[33:36, 49:56, 257:300]],
                               _blocks((36, 56, 300), (1, 1, 2), (4, 3, 2))),
    "two-adjacent": ((40, 32, 384), [S[0:8, 0:16, 0:256]],
                     _blocks((40, 32, 384), (0, 0, 0), (0, 0, 1))),
    # a plane of 2,048 labels on the first z plane of block (2, 1, 1): block
    # (1, 1, 1) is past L only through its far-face plane, block (2, 0, 1)
    # through its far-face plane's row z=16
    "far-face-plane": ((24, 48, 768), [S[0:8, 0:16, 0:128], S[16:17, 16:32, 128:256]],
                       _blocks((24, 48, 768), (0, 0, 0), (2, 1, 1), (1, 1, 1), (2, 0, 1))),
    # a lifted 2D image: block (1, 128, 128), clear of its near faces
    "2d": ((512, 500), [S[129:256, 129:256]], [1 * 4 + 1]),
}
VARIANTS = {name: (name, "uint16", None) for name in CASES}
VARIANTS["interior-int32"] = ("interior", "int32", None)
VARIANTS["interior-n_bucket"] = ("interior", "uint16", 777)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_a_split_equals_the_flat_engine_and_jax(variant):
    name, dtype, extra = VARIANTS[variant]
    shape, boxes, routed = CASES[name]
    img = _image(shape, boxes)
    st = LabeledStack.from_array(img, background=1, device="cpu")
    assert st.dense.dtype == torch.uint16
    if dtype == "int32":
        st = dataclasses.replace(st, dense=st.dense.to(torch.int32))
    n_bucket = None if extra is None else st.n_labels + extra
    engine.reroutes = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with timing.collect(fence=False) as t:
            d = engine.dispatch_stack(st, n_bucket=n_bucket)
            got = engine.collect_stack(d)
    assert engine.reroutes == 0
    assert t.counts[d.pass_id]["splits"] == 1 and t.counts[d.pass_id]["sweeps"] == 1
    assert d.L == 32 and d.split[0].tolist() == sorted(routed)
    assert t.counts[d.pass_id]["split.blocks"] == len(routed)
    assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)
    assert_tables_equal(jax_engine.analyze_stack_chunked(JaxStack.from_array(img, background=1)),
                        got)


# --------------------------------------------------------------- the rule
#: the flat engine's bytes over a 512³ stack, its default chunk
W512 = stencil.pair_sweep_bytes((512, 512, 512))


def test_the_rule_over_count_vectors():
    """The overseg frame's counts (8,192 blocks, 4 past L=32: the dense
    block, saturated, and its z-, y- and x-predecessors) split at L=32 into
    those 4; where every block is past, or the one block of an image is,
    no split pays; where none is past there is none to make; a larger L
    is taken where it routes fewer blocks for fewer bytes."""
    bound = 2600
    counts = np.full(8192, 20, np.int32)
    b = 4242
    counts[[b, b - 128, b - 4, b - 1]] = [bound + 1, 2050, 1030, 130]
    need, L, over = engine.split_plan(counts, 32, bound, BLOCK, W512)
    assert (L, over.tolist()) == (32, [b - 128, b - 4, b - 1, b])
    assert need == engine.sweep_bytes(8192, 32) + flat_blocks.routed_bytes(BLOCK, 4)
    assert need < 0.25 * 2**30
    assert engine.split_plan(np.full(8192, bound + 1, np.int32), 32, bound, BLOCK, W512) is None
    one = stencil.pair_sweep_bytes(BLOCK)
    assert engine.split_plan(np.array([bound + 1], np.int32), 32, bound, BLOCK, one) is None
    assert engine.split_plan(np.full(8192, 32, np.int32), 32, bound, BLOCK, W512) is None
    need, L, over = engine.split_plan(np.array([40, 40, 40, 5000]), 32, 4096, BLOCK, W512)
    assert (L, over.tolist()) == (64, [3])
    assert need == engine.sweep_bytes(4, 64) + flat_blocks.routed_bytes(BLOCK, 1)


#: the most blocks of a 512³ stack a split at L=32 routes
K512 = (W512 - engine.sweep_bytes(8192, 32) - 1) // flat_blocks.routed_bytes(BLOCK, 1)


@pytest.mark.parametrize("k", [1, 4, 60, K512, K512 + 1, 300, 1000, 8191, 8192])
def test_a_split_never_takes_more_bytes_than_the_flat_engine(k):
    """k blocks of 8,192 (512³) past every dictionary, spread over the
    stack: they are routed while the split's bytes are fewer than the flat
    engine's over the stack (up to ``K512`` blocks), and fewer than a chunk
    of voxels is then routed; past that the whole stack goes to the flat
    engine. With chunks of 2²¹ voxels the flat engine takes fewer bytes
    than the block sweep's outputs alone, and nothing is split."""
    assert 100 < K512 < 120
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 33, 8192).astype(np.int32)
    over = np.sort(rng.choice(8192, k, replace=False))
    counts[over] = 2601
    plan = engine.split_plan(counts, 32, 2600, BLOCK, W512)
    assert (plan is not None) == (k <= K512)
    if plan is not None:
        need, L, routed = plan
        assert need < W512 and L == 32 and routed.tolist() == over.tolist()
        assert routed.size * math.prod(BLOCK) < segred.DEFAULT_CHUNK
    small = stencil.pair_sweep_bytes((512, 512, 512), 1 << 21)
    assert small < engine.sweep_bytes(8192, 32)
    assert engine.split_plan(counts, 32, 2600, BLOCK, small) is None


def test_no_block_past_its_count_reads_no_count(monkeypatch):
    """Where the count finds an L for every block, nothing is routed: the
    route is never asked and the table is the block sweep's."""
    st = LabeledStack.from_array(_image((16, 32, 256), []), background=1, device="cpu")

    def never(d):
        raise AssertionError("routed")

    monkeypatch.setattr(engine, "_route", never)
    with timing.collect(fence=False) as t:
        d = engine.dispatch_stack(st)
        got = engine.collect_stack(d)
    assert d.split is None
    assert t.counts == {d.pass_id: {"sweeps": 1}}
    assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)


def test_memory_short_at_the_counted_L(monkeypatch):
    """A block of 600 labels, inside the bound: the count asks for L=1024,
    whose outputs a stand-in device cannot give. Where it can give the
    split's bytes, ``auto`` sweeps at the split's L with the blocks past it
    flat; a byte fewer, it reroutes the whole stack with a warning. Both
    tables equal the flat engine's."""
    img = _image((40, 32, 384), [])
    img[0:8, 0:16, 128:256] = img.max() + 1 + np.arange(8 * 16 * 128).reshape(8, 16, 128) // 28
    st = LabeledStack.from_array(img, background=1, device="cpu")
    counts = bs.block_label_counts(st.dense, st.n_labels, BLOCK, 4096).numpy()
    assert 512 < counts.max() <= 1024
    need, L, over = engine.split_plan(counts, 32, 4096, BLOCK, stencil.pair_sweep_bytes(st.shape))
    assert need < engine.sweep_bytes(counts.size, 1024)
    want = engine.analyze_stack(st, engine="chunked")
    for give, routed in ((need, True), (need - 1, False)):
        monkeypatch.setattr(engine, "givable_bytes", lambda dev, want: give)
        engine.reroutes = 0
        with timing.collect(fence=False) as t:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                d = engine.dispatch_stack(st)
                got = engine.collect_stack(d)
        if routed:
            assert (engine.reroutes, len(caught), d.L) == (0, 0, L)
            assert d.split[0].tolist() == over.tolist()
            assert t.counts[d.pass_id] == {"splits": 1, "split.blocks": over.size, "sweeps": 1}
        else:
            assert (engine.reroutes, len(caught)) == (1, 1)
            assert "L=1024" in str(caught[0].message)
        assert_tables_equal(want, got)


def test_the_flat_blocks_helpers_on_a_ragged_stack():
    """The boxes hold the pad label past the image and past the label
    space; the rows and keys of every block of a stack add up to the flat
    engine's moments and pairs."""
    img = _image((20, 40, 300), [])
    st = LabeledStack.from_array(img, background=1, device="cpu")
    n = st.n_labels
    B = engine.n_blocks(st.shape, BLOCK)
    origins = torch.from_numpy(flat_blocks.block_origins(np.arange(B), st.shape, BLOCK))
    assert origins[:, 1 + 3 + 9].tolist() == [8, 16, 128]
    box, coords = flat_blocks.gather_blocks(st.dense, n, BLOCK, origins)
    assert box.shape == (B, 9, 17, 129) and box.dtype == torch.int32
    # a box's entries inside the image, per axis, summed over the blocks
    inside = np.prod([sum(min(b + 1, s - o) for o in range(0, s, b))
                      for s, b in zip(img.shape, BLOCK)])
    assert int((box == n).sum()) == B * 9 * 17 * 129 - inside
    fin = engine.flat_sweep(st)
    seg, mom, coord = flat_blocks.moment_rows(box, coords, BLOCK)
    table = torch.zeros((n + 1, 10), dtype=torch.int64).index_add_(0, seg, mom)
    assert torch.equal(table[:n], fin.mom)
    key, ok = flat_blocks.pair_keys(box, n)
    ukey, total = torch.unique(key[ok], return_counts=True)
    assert torch.equal(ukey, fin.pkey) and torch.equal(total, fin.ptotal)
    small, _ = flat_blocks.gather_blocks(st.dense, 2, BLOCK, origins[:, :1])
    assert set(small.unique().tolist()) <= {0, 1, 2}
