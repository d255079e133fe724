"""The EmbeddingBag kernel's warp shape and summation order, on the CPU,
and its bits on the card.

``ops.geometry(D, L, align)`` picks the kernel's warp (lanes a bag,
floats a lane load, the L it is built for, rounds a tile) in Python, so
these tests reach the choice at every width and bag size.
``ref.embedding_bags_ordered`` states the kernel's order and rounding
(lookups added one at a time from 0, l = 0 .. L-1; one rounding for each
product, sum and the mean's division): it is held within 1e-5 (relative
to max(1, max |ref|), the EmbeddingBag tolerance of
``tests/test_kernels.py``) of the JAX package's ``embedding_bag_ref`` and
``models.dlrm.embedding_bag`` (weights) on inputs made with numpy from a
seed, with indices that count from the end and indices out of range
(NaN bags), and of the Pallas kernel ``embedding_bag_fwd`` in interpret
mode on indices in range.  The wrapper checks a list of tables from its
key at every call, so it sees a changed table, and a ``prepare_tables``
handle once.

The ``gpu`` tests skip (from a fixture) without a card: there the kernel,
at every width and bag size here, in every shape the C entry takes,
equals ``embedding_bags_ordered`` bit for bit, and a shape the entry
lacks raises.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.kernel import embedding_bag_fwd as j_fwd
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_ref
from repro.models import dlrm as jdlrm
from repro_torch.configs import recsys_archs
from repro_torch.data.pipeline import RecSysBatchSpec, recsys_batch
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bags_ordered,
                                                   embedding_bags_ref)
from repro_torch.models import dlrm

TOL = 1e-5
WIDTHS = (1, 2, 7, 8, 64, 70, 128)
BAG_SIZES = (0, 1, 4, 5, 33)


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=tol * max(1.0, np.nanmax(np.abs(want), initial=0.0)),
        equal_nan=True)


def same_bits(got, want):
    """Equal as f32 bits, NaN in the same places (any NaN)."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def inputs(seed, vocabs, B, L, D, wild=True):
    """Tables [V_f, D], indices [B, F, L] (in [-V - 2, V + 2) when
    ``wild``: from the end and out of range, else in [0, V)) and
    weights; numpy, from a seed."""
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((v, D)).astype(np.float32)
              for v in vocabs]
    lo = (lambda v: -v - 2) if wild else (lambda v: 0)
    hi = (lambda v: v + 2) if wild else (lambda v: v)
    idx = np.stack([rng.integers(lo(v), hi(v), (B, L)) for v in vocabs],
                   1).astype(np.int32).reshape(B, len(vocabs), L)
    w = rng.standard_normal(idx.shape).astype(np.float32)
    return tables, idx, w


def torch_args(tables, idx, w, dev="cpu"):
    return ([torch.from_numpy(t).to(dev) for t in tables],
            torch.from_numpy(idx).to(dev),
            None if w is None else torch.from_numpy(w).to(dev))


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("L", BAG_SIZES)
@pytest.mark.parametrize("D", WIDTHS)
def test_every_width_and_bag_size_has_a_geometry(D, L):
    for align in (16, 8, 4):
        g = ops.geometry(D, L, align)
        assert g.lanes in (1, 2, 4, 8, 16, 32) and g.vec in (1, 2, 4)
        assert D % g.vec == 0 and align % (4 * g.vec) == 0
        assert g.lanes == 32 or g.lanes * g.vec >= D
        if L in ops.TILE_L:                    # the tile kernel
            assert g.lt == L and g.lanes >= L
            assert g.bags * L <= 32                     # one index a lane
            assert g.rounds * L * g.vec <= ops.LOAD_FLOATS
            # the most rounds that keep both
            r = 2 * g.rounds
            assert (32 // g.lanes) * r * L > 32 \
                or r * L * g.vec > ops.LOAD_FLOATS
        else:                                  # CHUNK lookups a step
            assert g.lt == 0 and g.rounds == 1 and g.lanes >= ops.CHUNK
        # the fewest lanes that cover D, unless L or CHUNK asks for more
        cover = min(32, 1 << (-(-D // g.vec) - 1).bit_length())
        assert g.lanes == max(cover, g.lt or ops.CHUNK)


@pytest.mark.parametrize("D,L,align,want", [
    (64, 4, 16, (16, 4, 4, 2)),    # RM2: float4, half a warp a bag, 4 bags
    (64, 4, 8, (32, 2, 4, 4)),     # float2: a warp a bag, 4 bags
    (64, 4, 4, (32, 1, 4, 8)),     # unaligned: scalar lanes, two strips
    (7, 4, 16, (8, 1, 4, 2)),      # odd: scalar lanes
    (1, 1, 16, (1, 1, 1, 1)),      # 32 bags of one lookup a tile
    (8, 1, 16, (2, 4, 1, 2)),
    (128, 4, 16, (32, 4, 4, 2)),
    (128, 8, 16, (32, 4, 8, 1)),
    (70, 4, 16, (32, 2, 4, 4)),    # float2, two strips of 64 columns
    (1, 5, 16, (8, 1, 0, 1)),      # any other L: CHUNK lanes at least
    (64, 33, 16, (16, 4, 0, 1)),
    (64, 0, 16, (16, 4, 0, 1)),
])
def test_geometry_picks(D, L, align, want):
    g = ops.geometry(D, L, align)
    assert tuple(g) == want
    assert g.bags == 32 // want[0] * want[3]


def test_odd_or_unaligned_widths_take_scalar_lanes():
    for D in (1, 7, 33, 65):
        assert ops.geometry(D, 4).vec == 1
    for align in (4, 2, 1):
        assert ops.geometry(64, 4, align).vec == 1
    assert ops.geometry(64, 4, 8).vec == 2 and ops.geometry(66, 4).vec == 2


def test_geometry_refuses_what_no_kernel_runs():
    for D, L in ((0, 4), (64, -1)):
        with pytest.raises(ValueError, match="no geometry"):
            ops.geometry(D, L)


def test_kernel_constants_match_the_wrapper():
    """The C source's rounds formula reads the same constants as
    ``ops.tile_rounds``."""
    src = ops.SOURCE.read_text()
    assert re.search(r"constexpr int LOAD_FLOATS = (\d+);", src)[1] == str(
        ops.LOAD_FLOATS)
    assert f"constexpr int CHUNK = {ops.CHUNK};" in src
    assert ops.tile_rounds(16, 4, 4) == 2
    assert ops.tile_rounds(16, 4, 0) == 1


# ------------------------------------------------------ the ordered sum

@pytest.mark.parametrize("L", BAG_SIZES)
@pytest.mark.parametrize("D", WIDTHS)
def test_ordered_sum_vs_jax(D, L):
    """Sum and mean, with and without weights, indices from the end and
    out of range (NaN bags), against ``jnp.take`` and a sum over L."""
    vocabs = (13, 5)
    tables, idx, w = inputs(D * 100 + L, vocabs, 9, L, D)
    for combiner in ops.COMBINERS:
        got = embedding_bags_ordered(*torch_args(tables, idx, None),
                                     combiner)
        got_w = embedding_bags_ordered(*torch_args(tables, idx, w), combiner)
        for f in range(len(vocabs)):
            t, i = jnp.asarray(tables[f]), jnp.asarray(idx[:, f])
            close(got[:, f], j_ref(t, i, combiner))
            close(got_w[:, f], jdlrm.embedding_bag(
                t, i, jnp.asarray(w[:, f]), combiner))
        close(got_w, embedding_bags_ref(*torch_args(tables, idx, w),
                                        combiner))
        if L:
            assert torch.isnan(got).any()


@pytest.mark.parametrize("D,L", [(1, 1), (7, 4), (64, 4), (70, 5),
                                 (128, 8), (8, 33)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_ordered_sum_vs_pallas_interpret(D, L, combiner):
    tables, idx, _ = inputs(D + L, (40,), 6, L, D, wild=False)
    got = embedding_bags_ordered(*torch_args(tables, idx, None), combiner)
    want = j_fwd(jnp.asarray(tables[0]), jnp.asarray(idx[:, 0]),
                 combiner=combiner, interpret=True)
    close(got[:, 0], want)


def test_ordered_sum_is_the_lookup_order():
    """l = 0 .. L-1 from 0, a rounding each: ((1e8 + 1) - 1e8) + 3 = 3 in
    f32, where a pairwise sum gives 4; the mean divides by L once."""
    table = torch.tensor([[1e8], [1.0], [-1e8], [3.0]])
    idx = torch.tensor([[[0, 1, 2, 3]]], dtype=torch.int32)
    assert embedding_bags_ordered([table], idx).item() == 3.0
    assert embedding_bags_ordered([table], idx, None, "mean").item() == 0.75
    w = torch.tensor([[[1.0, 0.5, 1.0, 2.0]]])
    f = np.float32
    want = f(f(f(f(1e8) + f(0.5)) + f(-1e8)) + f(6.0))
    assert embedding_bags_ordered([table], idx, w).item() == want


def test_ordered_sum_of_an_empty_bag_and_table():
    """L = 0: a sum of 0 and a mean of NaN, as JAX; an empty table makes
    every lookup NaN."""
    t = torch.ones(3, 2)
    idx = torch.zeros(4, 1, 0, dtype=torch.int32)
    assert not embedding_bags_ordered([t], idx).any()
    assert torch.isnan(embedding_bags_ordered([t], idx, None, "mean")).all()
    empty = embedding_bags_ordered([torch.zeros(0, 2)],
                                   torch.zeros(2, 1, 3, dtype=torch.int32))
    assert empty.shape == (2, 1, 2) and torch.isnan(empty).all()


# ------------------------------------------- the wrapper's checks and cache

def test_a_list_of_tables_is_checked_from_its_key_at_every_call():
    ops._checked.cache_clear()
    t = torch.zeros(4, 4)
    idx = torch.zeros(2, 1, 3, dtype=torch.int32)
    ops.embedding_bags([t], idx)
    ops.embedding_bags([t], idx)
    ops.embedding_bags([t.view(4, 4)], idx)   # another object, same key
    info = ops._checked.cache_info()
    assert (info.hits, info.misses) == (2, 1)
    # the same pointer, shape, dtype and device, other strides
    with pytest.raises(ValueError, match="table 0.*contiguous=False"):
        ops.embedding_bags([t.t()], idx)
    with pytest.raises(ValueError, match="table 0"):
        ops.embedding_bags([t.view(torch.int32)], idx)
    with pytest.raises(ValueError, match="table 1"):
        ops.embedding_bags([t, t[:, :3]], torch.zeros(2, 2, 3,
                                                      dtype=torch.int32))


@pytest.mark.parametrize("change", ["t_", "resize_", "as_strided_", "set_",
                                    "unsqueeze_", "data"])
def test_a_changed_table_in_a_list_is_seen(change):
    """The same table object, changed in place at the same pointer (or
    given a view of its own storage): the next call over a list checks
    it again."""
    t = torch.zeros(8, 4)
    idx = torch.zeros(2, 1, 3, dtype=torch.int32)
    ops.embedding_bags([t], idx)
    ptr = t.data_ptr()
    {"t_": lambda: t.t_(), "resize_": lambda: t.resize_(2, 16),
     "as_strided_": lambda: t.as_strided_((4, 8), (1, 4)),
     "set_": lambda: t.set_(t.untyped_storage(), 0, (8, 4), (1, 8)),
     "unsqueeze_": lambda: t.unsqueeze_(0),
     "data": lambda: setattr(t, "data", t[:3])}[change]()
    assert t.data_ptr() == ptr
    if change == "resize_":               # still a contiguous table
        assert ops.embedding_bags([t], idx).shape == (2, 1, 16)
    elif change == "data":                # three rows, not eight
        assert ops._key([t])[0][1] == (3, 4)
        assert ops.embedding_bags([t], torch.full(
            (1, 1, 1), 5, dtype=torch.int32)).isnan().all()
    else:
        with pytest.raises(ValueError, match="table 0"):
            ops.embedding_bags([t], idx)


def test_prepared_tables_are_checked_once():
    tables, idx, w = inputs(11, (20, 30), 9, 4, 8)
    tables, idx, w = torch_args(tables, idx, w)
    ops._checked.cache_clear()
    prepared = ops.prepare_tables(tables)
    assert isinstance(prepared, tuple) and len(prepared) == 2
    assert all(a is b for a, b in zip(prepared, tables))
    assert (prepared.meta, prepared.D, prepared.align) == (None, 8, 16)
    assert prepared.device == torch.device("cpu")
    for combiner in ops.COMBINERS:
        same_bits(ops.embedding_bags(prepared, idx, w, combiner),
                  ops.embedding_bags(tables, idx, w, combiner))
    info = ops._checked.cache_info()     # prepared, then the list's calls
    assert (info.hits, info.misses) == (2, 1)
    calls = ops._checked.cache_info()
    ops.embedding_bags(prepared, idx)
    assert ops._checked.cache_info() == calls
    # each table's check, when it is prepared
    with pytest.raises(ValueError, match="table 1.*contiguous=False"):
        ops.prepare_tables([tables[0], tables[1].t()])
    with pytest.raises(ValueError, match="table 1"):
        ops.prepare_tables([tables[0], tables[1].double()])
    with pytest.raises(ValueError, match="no tables"):
        ops.prepare_tables([])
    # and the call's own checks
    with pytest.raises(ValueError, match="2 tables for 3 fields"):
        ops.embedding_bags(prepared, torch.zeros(2, 3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bags(prepared, idx, w[:, :1])
    meta_dev = torch.device("meta")
    with pytest.raises(ValueError, match="prepared on cpu"):
        ops.embedding_bags(prepared, idx.to(meta_dev))


def test_dlrm_serves_over_prepared_tables():
    cfg = recsys_archs._smoke(recsys_archs.DLRM_RM2)
    params = dlrm.init_dlrm_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in recsys_batch(
        RecSysBatchSpec(16, cfg.n_dense, cfg.n_sparse,
                        cfg.lookups_per_field, cfg.resolved_vocabs()),
        0).items()}
    served = dlrm.prepare_dlrm_params(params)
    assert isinstance(served["tables"], ops.BagTables)
    assert served["bot"] is params["bot"] and served["top"] is params["top"]
    same_bits(dlrm.dlrm_forward(cfg, served, batch),
              dlrm.dlrm_forward(cfg, params, batch))


def test_a_new_table_at_a_freed_tables_address_is_checked():
    """A list's tables are checked by their key, not by object: a new
    table where an old one was, in another layout, is refused."""
    idx = torch.zeros(2, 1, 3, dtype=torch.int32)
    storage = torch.zeros(32)
    t = storage.view(8, 4)
    ops.embedding_bags([t], idx)
    del t
    u = storage.view(4, 8).t()            # same pointer, not contiguous
    with pytest.raises(ValueError, match="contiguous=False"):
        ops.embedding_bags([u], idx)


def test_launch_runs_only_on_the_card():
    t = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="runs on cuda"):
        ops.launch([t], torch.zeros(2, 1, 3, dtype=torch.int32))


def test_contiguity_from_shape_and_strides_is_torchs():
    base = torch.zeros(6, 8)
    for t in (base, base.t(), base[:, :4], base[::2], base[:1], base[:, :1],
              base[:0], base.view(48)[None], base.expand(2, 6, 8)[0],
              torch.zeros(5, 1).expand(5, 3)):
        assert ops._contiguous(t.shape, t.stride()) == t.is_contiguous()


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs the RM2 shapes there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", BAG_SIZES)
@pytest.mark.parametrize("D", WIDTHS)
def test_kernel_equals_ordered_sum_bit_for_bit(card, D, L):
    """n_bags = 3 x 37 = 111, a multiple of no tile (1, 2, 4, .. 32
    bags); weighted and not, sum and mean, wild indices."""
    tables, idx, w = inputs(D * 7 + L, (50, 1, 300), 37, L, D)
    for weights in (None, w):
        cpu = torch_args(tables, idx, weights)
        dev = torch_args(tables, idx, weights, card)
        for combiner in ops.COMBINERS:
            before = ops.launches
            got = ops.embedding_bags(*dev, combiner)
            assert ops.launches == before + 1
            same_bits(got, embedding_bags_ordered(*cpu, combiner))
            same_bits(got, embedding_bags_ordered(*dev, combiner))


@pytest.mark.gpu
@pytest.mark.parametrize("D,L", [(64, 4), (64, 1), (8, 8), (70, 2)])
def test_every_shape_gives_the_same_bits(card, D, L):
    """Every shape the C entry takes at (D, L), the chunked kernel
    included, gives the ordered sum's bits."""
    tables, idx, w = inputs(D + L, (90, 3), 45, L, D)
    dev = torch_args(tables, idx, w, card)
    want = embedding_bags_ordered(*dev, "mean")
    shapes = set()
    for vec in (1, 2, 4):
        if D % vec:
            continue
        for lanes in (1, 2, 4, 8, 16, 32):
            if lanes < 32 and lanes * vec < D:
                continue
            for lt in (0, L):
                if lanes < (lt or ops.CHUNK):
                    continue
                shapes.add(ops.Geometry(lanes, vec, lt,
                                        ops.tile_rounds(lanes, vec, lt)))
    assert ops.geometry(D, L) in shapes
    for g in sorted(shapes):
        same_bits(ops.launch(*dev, "mean", shape=g), want)


@pytest.mark.gpu
def test_unaligned_tables_take_scalar_lanes(card):
    tables, idx, _ = inputs(3, (20, 30), 50, 4, 64, wild=False)
    flat = [torch.from_numpy(np.concatenate([[0.0], t.ravel()]).astype(
        np.float32)).to(card) for t in tables]
    views = [f[1:].view(-1, 64) for f in flat]        # 4-byte aligned
    idx_d = torch.from_numpy(idx).to(card)
    got = ops.embedding_bags(views, idx_d)
    same_bits(got, embedding_bags_ordered(views, idx_d))
    before = dict(ops.shape_launches)
    ops.embedding_bags(views, idx_d)
    assert {g: n - before.get(g, 0) for g, n in ops.shape_launches.items()
            if n != before.get(g, 0)} == {ops.Geometry(32, 1, 4, 8): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("D,bad", [
    (64, ops.Geometry(16, 4, 4, 2 * ops.tile_rounds(16, 4, 4))),  # 2x R
    (64, ops.Geometry(3, 4, 4, 1)),      # lanes not a power of two
    (64, ops.Geometry(8, 4, 4, 2)),      # 8 lanes x 4 floats < D
    (64, ops.Geometry(16, 4, 2, 4)),     # built for another L
    (64, ops.Geometry(32, 3, 4, 8)),     # no such vector
    (6, ops.Geometry(2, 4, 4, 1)),       # float4 on D % 4 != 0
    (8, ops.Geometry(2, 4, 0, 1)),       # the chunked kernel under 8 lanes
])
def test_a_shape_the_entry_lacks_raises(card, D, bad):
    tables, idx, _ = inputs(5, (20,), 8, 4, D)
    dev = torch_args(tables, idx, None, card)
    before = ops.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.launch(*dev, shape=bad)
    assert ops.launches == before


@pytest.mark.gpu
def test_the_card_sees_a_changed_table(card):
    t = torch.zeros(4, 4, device=card)
    idx = torch.zeros(2, 1, 3, dtype=torch.int32, device=card)
    ops.embedding_bags([t], idx)
    # narrowed to a view at the same address: the rows past its end read
    # NaN, over a list and over a handle prepared again
    t.data = t[:2]
    past = torch.full((1, 1, 1), 3, dtype=torch.int32, device=card)
    assert ops.embedding_bags([t], past).isnan().all()
    assert ops.embedding_bags(ops.prepare_tables([t]), past).isnan().all()
    with pytest.raises(ValueError, match="prepared on cuda"):
        ops.embedding_bags(ops.prepare_tables([t]), past.cpu())
    with pytest.raises(ValueError, match="contiguous=False"):
        ops.embedding_bags([t.t()], idx)
    with pytest.raises(ValueError, match="table 0"):
        ops.embedding_bags([t.cpu()], idx)
