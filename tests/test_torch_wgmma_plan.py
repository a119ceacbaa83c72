"""The launch shapes of the bf16 wgmma kernels, computed on the host.

`k1_bf16_plan` (K1-bf16, forward and dx) and `dw_bf16_plan` (K1-dW-bf16) in
dycon_paper_replication_tpu_torch/ops/folded_conv_cuda.py cut a conv into
tiles, TMA boxes and split-K chunks, which the C entries take as they are
(and encode the tensor maps from).
Here, at every (grid, L_in, L_out, phase) that chip_smoke.py drives (the
Pancreas training and eval shapes, ISLES's and the VNet's): each is
accepted (L_in 8 goes to the mma.sync instance), the tensor maps' strides
are 16-byte multiples, every box dim is 1 to 256 with 64 lanes innermost,
the shared memory fits a block, the tiles cover the output exactly once,
and the splits cover the voxel tiles; shapes the kernels cannot take raise.
"""

import importlib.util
import itertools
from pathlib import Path

import pytest

from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    DW_WG_MAX_CHUNK,
    K1_WG_ROWS,
    SMEM_LIMIT,
    TMA_BOX_MAX,
    WG_LANES,
    WG_SEG,
    dw_bf16_plan,
    k1_bf16_plan,
)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_shapes", Path(__file__).resolve().parent.parent / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)

# (path, batch, layer, fold grid G of the input, L_in, L_out, to_phase)
SHAPES = [(path, batch, *shape)
          for path, batch, shapes in (("train", _smoke.TRAIN_BATCH, _smoke.TRAIN_SHAPES),
                                      ("isles", _smoke.TRAIN_BATCH, _smoke.ISLES_SHAPES),
                                      ("vnet", _smoke.TRAIN_BATCH, _smoke.VNET_TRAIN_SHAPES),
                                      ("eval", _smoke.PATCH_BATCH, _smoke.K1_SHAPES),
                                      ("brats", _smoke.TRAIN_BATCH, _smoke.K1_SHAPES))
          for shape in shapes]
IDS = [f"{s[0]}-{s[2]}" for s in SHAPES]


def _out_grid(g, to_phase):
    return tuple(n + (1 if to_phase == 1 else -1) for n in g)


def _check_map(dims, strides, box):
    assert len(dims) == len(box) and len(strides) == len(dims) - 1
    assert all(s % 16 == 0 and s < 2 ** 40 for s in strides)
    assert strides[0] == 2 * dims[0]
    assert all(1 <= b <= TMA_BOX_MAX for b in box) and box[0] == WG_LANES


def _k1_plans(batch, g, lin, lout, to_phase):
    """(forward plan, dx plan or None): dx where the conv's input needs a
    gradient (L_in 8 is the image's conv), in the opposite phase."""
    fwd = k1_bf16_plan((batch, *g, lin), lout, to_phase)
    dx = None if lin == 8 else k1_bf16_plan((batch, *_out_grid(g, to_phase), lout), lin,
                                            1 - to_phase)
    return fwd, dx


@pytest.mark.parametrize("path,batch,layer,g,lin,lout,to_phase", SHAPES, ids=IDS)
def test_k1_bf16_plan_at_the_smoke_shapes(path, batch, layer, g, lin, lout, to_phase):
    fwd, dx = _k1_plans(batch, g, lin, lout, to_phase)
    if lin == 8:
        assert fwd is None  # the mma.sync instance
        return
    for plan, (xg, li, lo, phase) in ((fwd, (g, lin, lout, to_phase)),
                                     (dx, (_out_grid(g, to_phase), lout, lin, 1 - to_phase))):
        q1, q2, q3 = _out_grid(xg, phase)
        wv = plan.sw + 1
        assert plan.x_dims == (li, xg[2], xg[1], xg[0], batch)
        assert plan.x_box == (WG_LANES, wv, plan.rows + 1, 2, 1)
        assert plan.wf_dims == (lo, 8 * li) and plan.wf_box == (64, 64)
        _check_map(plan.x_dims, plan.x_strides, plan.x_box)
        _check_map(plan.wf_dims, plan.wf_strides, plan.wf_box)
        assert plan.y_dims == (lo, q3, q2, q1, batch)
        assert plan.y_box == (64, plan.sw, plan.rows, 1, 1)
        _check_map(plan.y_dims, plan.y_strides, plan.y_box)
        assert plan.sw <= WG_SEG and plan.rows * wv <= K1_WG_ROWS
        hr = (plan.rows + 1) * wv
        assert plan.halo_rows % 8 == 0 and plan.halo_rows >= 2 * hr
        assert plan.halo_rows >= K1_WG_ROWS + hr + wv + 1  # the taps' reads past the tile
        assert 2 <= plan.wf_slots <= 4 and plan.smem_bytes <= SMEM_LIMIT
        nseg, htiles = plan.tiles[0] // -(-q2 // plan.rows), -(-q2 // plan.rows)
        assert plan.tiles == (nseg * htiles, lo // 128, batch * q1)
        assert (nseg - 1) * plan.sw < q3 <= nseg * plan.sw
        assert (htiles - 1) * plan.rows < q2 <= htiles * plan.rows
        # at least 70 % of the M tile's rows are output voxels
        assert q2 * q3 / (nseg * htiles * K1_WG_ROWS) >= 0.7, (q2, q3, plan)


@pytest.mark.parametrize("path,batch,layer,g,lin,lout,to_phase", SHAPES, ids=IDS)
def test_dw_bf16_plan_at_the_smoke_shapes(path, batch, layer, g, lin, lout, to_phase):
    plan = dw_bf16_plan((batch, *g, lin), lout, to_phase, 132)
    if lin == 8:
        assert plan is None
        return
    q1, q2, q3 = _out_grid(g, to_phase)
    assert plan.x_dims == (lin, g[2], g[1], g[0], batch)
    assert plan.dy_dims == (lout, q3, q2, q1, batch)
    assert plan.x_box == (WG_LANES, plan.sw + 1, plan.rows + 1, 1, 1)
    assert plan.dy_box == (64, plan.sw, plan.rows, 1, 1)
    _check_map(plan.x_dims, plan.x_strides, plan.x_box)
    _check_map(plan.dy_dims, plan.dy_strides, plan.dy_box)
    assert plan.kpad % 16 == 0 and plan.kpad - 16 < plan.rows * plan.sw <= plan.kpad
    assert 2 <= plan.slots <= 4 and plan.smem_bytes <= SMEM_LIMIT
    nseg, htiles = -(-q3 // plan.sw), -(-q2 // plan.rows)
    assert plan.ntiles == batch * q1 * htiles * nseg
    assert (plan.splits - 1) * plan.chunk < plan.ntiles <= plan.splits * plan.chunk
    assert plan.chunk_voxels <= max(DW_WG_MAX_CHUNK, plan.kpad)
    assert plan.grid == (2 * lin // WG_LANES, lout // 128, plan.splits)
    assert plan.grid[0] * plan.grid[1] * plan.splits >= 132  # a full wave at least


@pytest.mark.parametrize("g,to_phase,lin", [((5, 7, 6), 1, 64), ((9, 10, 70), 1, 128),
                                            ((4, 30, 20), 0, 64), ((3, 3, 130), 0, 128)])
def test_k1_bf16_tiles_cover_each_output_once(g, to_phase, lin):
    """Each output voxel of a (b, qd) plane is written by exactly one row of
    one tile (the kernel's epilogue rule), at segment-cut grids too."""
    plan = k1_bf16_plan((1, *g, lin), 128, to_phase)
    _, q2, q3 = _out_grid(g, to_phase)
    wv, htiles = plan.sw + 1, -(-q2 // plan.rows)
    hits = {}
    for tile in range(plan.tiles[0]):
        seg, ht = divmod(tile, htiles)
        for m in range(K1_WG_ROWS):
            qh, c = divmod(m, wv)
            h, w = ht * plan.rows + qh, seg * plan.sw + c
            if qh < plan.rows and h < q2 and c < plan.sw and w < q3:
                hits[h, w] = hits.get((h, w), 0) + 1
    assert hits == {hw: 1 for hw in itertools.product(range(q2), range(q3))}


@pytest.mark.parametrize("g,to_phase", [((5, 7, 6), 1), ((4, 30, 20), 0), ((3, 3, 130), 0)])
def test_dw_bf16_tiles_cover_each_voxel_once(g, to_phase):
    """The voxel tiles (b, qd, row tile, segment), masked as the kernel masks
    them, take each dy voxel exactly once."""
    b = 2
    plan = dw_bf16_plan((b, *g, 64), 128, to_phase, 132)
    q1, q2, q3 = _out_grid(g, to_phase)
    nseg, htiles = -(-q3 // plan.sw), -(-q2 // plan.rows)
    hits = {}
    for t in range(plan.ntiles):
        rest, seg = divmod(t, nseg)
        rest, ht = divmod(rest, htiles)
        bb, qd = divmod(rest, q1)
        h0, w0 = ht * plan.rows, seg * plan.sw
        for v in range(plan.kpad):
            vr, vc = divmod(v, plan.sw)
            if vr < min(plan.rows, q2 - h0) and vc < min(plan.sw, q3 - w0):
                key = (bb, qd, h0 + vr, w0 + vc)
                hits[key] = hits.get(key, 0) + 1
    assert hits == {k: 1 for k in itertools.product(range(b), range(q1), range(q2), range(q3))}


def test_unsupported_shapes_raise_or_take_the_mma_instance():
    assert k1_bf16_plan((1, 4, 4, 4, 136), 128, 1) is None  # L_in % 64: mma.sync
    assert dw_bf16_plan((1, 4, 4, 4, 8), 128, 1, 132) is None
    with pytest.raises(ValueError):
        k1_bf16_plan((1, 4, 4, 4, 64), 100, 1)  # L_out % 128
    with pytest.raises(ValueError):
        k1_bf16_plan((1, 1, 4, 4, 64), 128, 0)  # an empty output grid
    with pytest.raises(ValueError):
        k1_bf16_plan((70_000, 2, 4, 4, 64), 128, 1)  # B * Q1 past the grid's z
    with pytest.raises(ValueError):
        dw_bf16_plan((1, 4, 4, 4, 64), 192, 1, 132)
    with pytest.raises(ValueError):
        dw_bf16_plan((1, 4, 1, 4, 64), 128, 0, 132)
