"""Spatially + batch-sharded segmentation step (shard_map over the mesh).

The scale-out path for BASELINE config #5 (100× 2048²×50 stacks): planes are
sharded batch-wise over the "data" axis and row-wise over the "space" axis.
Windowed ops use halo exchange; the distributed CCL runs the same
min-propagation fixpoint as the single-chip kernel with per-iteration halo
exchange of boundary labels (cross-shard components converge through the
boundary each round) and shard-local pointer jumping.  Convergence is a
global ``psum`` of the per-shard change flag, so every shard exits together.

Design notes (SURVEY.md §2.8): collectives are ppermute/psum over the
device links — the replacement for the reference's nonexistent distributed
backend.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.ops.edt import (
    edt_sq,
    minplus_rows,
    row_dh2_exact,
)
from particle_col_image_segmentation_tpu.ops.filters import median_label_filter_padded
from particle_col_image_segmentation_tpu.ops.scans import (
    seg_min_scan_bidi,
    seg_or_scan_bidi,
)
from particle_col_image_segmentation_tpu.parallel.halo import pad_with_halo
from particle_col_image_segmentation_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS

from particle_col_image_segmentation_tpu.ops.watershed import _INF as _WS_INF

_INF = jnp.iinfo(jnp.int32).max
# the watershed pad fills MUST be the sentinels claim_candidates tests
# against — duplicating the literals here would silently break the
# bit-identical-schedule claim at shard boundaries if ops/watershed.py
# ever changed them
_FINF = _WS_INF

__all__ = [
    "sharded_segment_batch",
    "make_sharded_segment_fn",
    "make_sharded_analysis_fn",
    "make_sharded_full_analysis_fn",
    "make_sharded_dapi_dedup_fn",
    "make_sharded_refine_fn",
    "make_sharded_watershed_fn",
]


def _neighbor_min_padded(lab_p, img_p):
    """8-neighbor masked min where inputs carry a 1-px halo on rows/cols."""
    out = None
    H = lab_p.shape[-2] - 2
    W = lab_p.shape[-1] - 2
    center_img = img_p[..., 1 : 1 + H, 1 : 1 + W]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            lab_s = lab_p[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            img_s = img_p[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            cand = jnp.where(img_s == center_img, lab_s, _INF)
            out = cand if out is None else jnp.minimum(out, cand)
    return out


def _scan_masks(img):
    """Loop-invariant same-value masks for the row/column segmented scans
    (hoisted out of the fixpoint bodies — they depend only on the value
    image, not on the evolving labels)."""
    same_row = jnp.concatenate(
        [jnp.zeros(img.shape[:-1] + (1,), bool), img[..., :, 1:] == img[..., :, :-1]],
        axis=-1,
    )
    same_col = jnp.concatenate(
        [
            jnp.zeros(img.shape[:-2] + (1,) + img.shape[-1:], bool),
            img[..., 1:, :] == img[..., :-1, :],
        ],
        axis=-2,
    )
    return same_row, jnp.swapaxes(same_col, -1, -2)


def _local_scans(lab, masks):
    same_row, same_col_t = masks
    lab = seg_min_scan_bidi(lab, same_row, axis=-1)
    lab = jnp.swapaxes(
        seg_min_scan_bidi(jnp.swapaxes(lab, -1, -2), same_col_t, axis=-1),
        -1,
        -2,
    )
    return lab


def _local_pointer_jump(lab, base):
    """Jump only through targets resident on this shard (labels are global
    linear indices; base = first global index of the local band)."""
    shape = lab.shape
    flat = lab.reshape(shape[:-2] + (-1,))
    size = flat.shape[-1]
    local = flat - base
    ok = (local >= 0) & (local < size)
    idx = jnp.clip(local, 0, size - 1)
    jumped = jnp.take_along_axis(flat, idx, axis=-1)
    return jnp.minimum(flat, jnp.where(ok, jumped, _INF)).reshape(shape)


def _value_jump(vals, lab, base):
    """vals[p] ← min(vals[p], vals[root of p]) for on-shard roots (labels are
    global linear indices; base = first global index of the local band)."""
    shape = vals.shape
    flat_v = vals.reshape(shape[:-2] + (-1,))
    flat_l = lab.reshape(shape[:-2] + (-1,))
    size = flat_v.shape[-1]
    local = flat_l - base
    ok = (local >= 0) & (local < size)
    idx = jnp.clip(local, 0, size - 1)
    jumped = jnp.take_along_axis(flat_v, idx, axis=-1)
    return jnp.minimum(flat_v, jnp.where(ok, jumped, _INF)).reshape(shape)


def _linear_ids(shape_ref):
    """(lin, base, row_offset): global linear pixel ids for this shard's
    band, for any leading batch/context dims of ``shape_ref``."""
    h_loc, W = shape_ref.shape[-2:]
    sidx = jax.lax.axis_index(SPACE_AXIS)
    row_offset = sidx * h_loc
    base = row_offset * W
    rows = jax.lax.broadcasted_iota(jnp.int32, shape_ref.shape, shape_ref.ndim - 2)
    cols = jax.lax.broadcasted_iota(jnp.int32, shape_ref.shape, shape_ref.ndim - 1)
    lin = (rows + row_offset) * W + cols
    return lin, base, row_offset


def _dist_ccl(val, base, lin, max_iters):
    """Distributed equal-value CCL fixpoint: per-iteration halo exchange of
    boundary labels + shard-local segmented scans + pointer jumping, global
    psum convergence.  ``val`` is [..., h_loc, W] (any leading dims);
    labels converge to the global min linear index of each component.
    Returns (lab, ch_planes) with ch_planes summed over the trailing plane
    axes (0 = converged)."""
    img_p = pad_with_halo(val.astype(jnp.int32), 1, edge_mode="constant", fill=-1)
    img_p = jnp.pad(
        img_p, [(0, 0)] * (val.ndim - 1) + [(1, 1)], constant_values=-1
    )
    masks = _scan_masks(val)
    lin = jax.lax.pcast(lin, (DATA_AXIS,), to="varying")

    def body(state):
        lab, _, _, i = state
        lab_p = pad_with_halo(lab, 1, edge_mode="constant", fill=_INF)
        lab_p = jnp.pad(
            lab_p, [(0, 0)] * (lab.ndim - 1) + [(1, 1)], constant_values=_INF
        )
        new = _neighbor_min_padded(lab_p, img_p)
        new = _local_scans(new, masks)
        new = _local_pointer_jump(new, base)
        new = _local_pointer_jump(new, base)
        ch_planes = jax.lax.psum(
            jnp.any(new != lab, axis=(-2, -1)).astype(jnp.int32), SPACE_AXIS
        )
        changed = jax.lax.psum(
            jax.lax.psum(jnp.any(ch_planes > 0).astype(jnp.int32), SPACE_AXIS),
            DATA_AXIS,
        )
        return new, ch_planes, changed > 0, i + 1

    def cond(state):
        _, _, changed, i = state
        return changed & (i < max_iters)

    ch0 = jax.lax.pcast(
        jnp.ones(val.shape[:-2], jnp.int32), (DATA_AXIS,), to="varying"
    )
    lab, ch_planes, _, _ = jax.lax.while_loop(
        cond, body, (lin, ch0, jnp.bool_(True), 0)
    )
    return lab, ch_planes


def _compact_and_tables_shard(
    lab, lin, den, base, max_regions, max_iters, extra=(), fg=None,
):
    """Global compact ids + region tables from converged global root labels.

    Shards hold contiguous row bands in space-axis order, so the global
    raster rank of a root = (roots on earlier shards) + (local raster rank):
    one all_gather of per-shard root counts + a local cumsum.  Ranks then
    min-propagate from roots through their components with the same halo-
    exchange fixpoint as the CCL (value image = the root labels themselves,
    exactly component-constant), accelerated by root-gather jumps.  Tables
    are shard-local segment sums psum-reduced over the space axis.

    ``extra``: additional [b_loc, h_loc, W] planes segment-summed per region
    and psum'd alongside area/class (centroid coordinate sums for the merge
    stage, overlap masks for DAPI dedup); returned as the trailing tuple.

    ``fg``: optional bool plane gating which components receive ranks —
    only components whose root pixel is foreground get compact ids, exactly
    like the single-chip ``compact_labels`` on a ``background=0`` CCL
    (non-fg components' pixels come back as id 0).  Value-homogeneous
    components make root gating equivalent to component gating.
    """
    is_root = lab == lin
    if fg is not None:
        is_root = is_root & fg
    local_counts = jnp.sum(is_root.astype(jnp.int32), axis=(-2, -1))  # [b_loc]
    sidx = jax.lax.axis_index(SPACE_AXIS)
    all_counts = jax.lax.all_gather(local_counts, SPACE_AXIS)  # [n_space, b_loc]
    shard_ids = jax.lax.broadcasted_iota(jnp.int32, all_counts.shape, 0)
    before = jnp.sum(jnp.where(shard_ids < sidx, all_counts, 0), axis=0)

    ir = is_root.astype(jnp.int32)
    row_tot = jnp.sum(ir, axis=-1)  # [b_loc, h_loc]
    row_base = jnp.cumsum(row_tot, axis=-1) - row_tot
    rank = before[..., None, None] + row_base[..., None] + jnp.cumsum(ir, axis=-1)

    seed0 = jnp.where(is_root, rank, _INF)

    # value image (lab) is fixed under the loop: exchange its halo and build
    # the scan masks ONCE, not per iteration (one ppermute saved per round)
    l_p = pad_with_halo(lab, 1, edge_mode="constant", fill=-7)
    l_p = jnp.pad(l_p, [(0, 0)] * (lab.ndim - 1) + [(1, 1)], constant_values=-7)
    masks = _scan_masks(lab)
    b_planes = lab.shape[0]

    def body(state):
        s, _, _, i = state
        s_p = pad_with_halo(s, 1, edge_mode="constant", fill=_INF)
        s_p = jnp.pad(s_p, [(0, 0)] * (s.ndim - 1) + [(1, 1)], constant_values=_INF)
        new = _neighbor_min_padded(s_p, l_p)
        new = _local_scans(new, masks)
        new = _value_jump(new, lab, base)
        # per-plane change count over the space axis (planes on other DATA
        # shards are independent); the loop itself must exit in lockstep on
        # every device (collectives inside), hence the global any
        ch_planes = jax.lax.psum(
            jnp.any(new != s, axis=(-2, -1)).astype(jnp.int32), SPACE_AXIS
        )
        changed = jax.lax.psum(
            jax.lax.psum(jnp.any(ch_planes > 0).astype(jnp.int32), SPACE_AXIS),
            DATA_AXIS,
        )
        return new, ch_planes, changed > 0, i + 1

    def cond(state):
        _, _, changed, i = state
        return changed & (i < max_iters)

    ch0 = jax.lax.pcast(
        jnp.ones((b_planes,), jnp.int32), (DATA_AXIS,), to="varying"
    )
    seed, ch_planes, _, _ = jax.lax.while_loop(
        cond, body, (seed0, ch0, jnp.bool_(True), 0)
    )
    converged = ch_planes == 0  # [b_loc] per plane
    seg = jnp.where(seed == _INF, 0, seed)

    R = max_regions + 1

    def tables_one(s2, stacked):
        ids = s2.ravel()
        cols = jnp.concatenate(
            [jnp.ones((ids.shape[0], 1), jnp.int32),
             stacked.reshape(stacked.shape[0], -1).T.astype(jnp.int32)],
            axis=-1,
        )
        return jax.ops.segment_sum(cols, ids, num_segments=R)

    planes = jnp.stack((den.astype(jnp.int32),) + tuple(extra), axis=1)
    sums_l = jax.vmap(tables_one)(seg, planes)  # [b_loc, R, 2+len(extra)]
    sums = jax.lax.psum(sums_l, SPACE_AXIS)
    area = sums[..., 0]
    class_id = sums[..., 1] // jnp.maximum(area, 1)
    extra_sums = tuple(sums[..., 2 + k] for k in range(len(extra)))
    return seg, area, class_id, converged, extra_sums


def _merge_shard(den, area, sr_hi, sr_lo, sc_hi, sc_lo, cfg: AnalysisConfig,
                 strain_vals, max_iters: int):
    """Distributed proximity-merge grouping (labels/analysis.py:_stage_merge,
    reference tiff_analysis.py:826-851): per strain context + the union,
    dilate by disk(r), run the distributed CCL on the dilated masks, and
    read the global component root under every region's truncated centroid.

    Tables are replicated across the space axis, so centroids are derived
    locally; the gather happens on the band that owns the centroid row and
    is pmax-combined (roots ≥ 0 > the off-mask −1 > the off-band sentinel).
    Returns (g_ctx [b_loc, S+1, R+1], converged [b_loc]).
    """
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        _exact_floor_div,
    )

    h_loc, W = den.shape[-2:]
    n_sp = jax.lax.axis_size(SPACE_AXIS)
    Hg = n_sp * h_loc
    d = jnp.maximum(area, 1)
    icy = jnp.clip(_exact_floor_div(sr_hi, sr_lo, d), 0, Hg - 1)  # [b, R+1]
    icx = jnp.clip(_exact_floor_div(sc_hi, sc_lo, d), 0, W - 1)

    # empty strain_vals (e.g. an RFP plane with no cell class under the
    # 6B07/6B07+C3M10 rules): union-only context, like _stage_merge
    masks = [den == v for v in strain_vals]
    union = jnp.zeros(den.shape, bool)
    for m in masks:
        union = union | m
    ctx = jnp.stack(masks + [union], axis=0)  # [S, b, h, W]
    r = cfg.merge_disk_radius
    pm = pad_with_halo(ctx, r, edge_mode="constant", fill=False)
    dil = edt_sq(pm, cap=r)[..., r:-r, :] <= r * r  # dilate == EDT(X) ≤ r

    lin, base, row_offset = _linear_ids(dil)
    lab, ch = _dist_ccl(dil.astype(jnp.uint8), base, lin, max_iters)

    S, b = ctx.shape[0], ctx.shape[1]
    flat_lab = lab.reshape(S, b, h_loc * W)
    flat_dil = dil.reshape(S, b, h_loc * W).astype(jnp.int32)
    ly = icy - row_offset
    on_band = (ly >= 0) & (ly < h_loc)  # [b, R+1]
    idx = jnp.clip(ly, 0, h_loc - 1) * W + icx
    idxS = jnp.broadcast_to(idx[None], (S,) + idx.shape)
    g = jnp.take_along_axis(flat_lab, idxS, axis=-1)  # [S, b, R+1]
    on_mask = jnp.take_along_axis(flat_dil, idxS, axis=-1)
    sentinel = jnp.iinfo(jnp.int32).min
    local = jnp.where(
        on_band[None], jnp.where(on_mask > 0, g, -1), sentinel
    )
    g_ctx = jax.lax.pmax(local, SPACE_AXIS)  # owning band wins
    converged = jnp.all(ch == 0, axis=0)  # [b]
    return jnp.moveaxis(g_ctx, 0, 1), converged


def _segment_shard(
    img, cfg: AnalysisConfig, particle_val: int, cell_vals, max_iters: int,
    with_tables: bool = False, with_merge: bool = False,
    with_analysis: bool = False, denoise: bool = True,
):
    """Body run per shard: [b_loc, h_loc, W] →
    (den, lab, particle_ct, n_comp, filled, overlap_ct[, seg, area, class_id]).

    ``with_analysis`` (implies tables) switches to the full
    PlaneDeviceOut-grade outputs: per-STRAIN overlap counts [b, S], the
    exact centroid coordinate sums, region bboxes (segment min/max pmax'd
    over the space axis, half-open like ops.regionprops), and ``g_ctx`` —
    everything labels.analysis.analyze_plane_device computes, sharded
    (``with_merge=False`` skips the merge compute and returns the same -1
    placeholder g_ctx as the single-chip ``compute_merge=False``).
    ``denoise=False`` analyzes the plane as-is (the reference re-analysis
    paths, tiff_analysis.py:168,206)."""
    if with_analysis:
        with_tables = True
    h_loc, W = img.shape[-2:]
    if denoise:
        half = cfg.denoise_size // 2
        img_h = pad_with_halo(img, half, edge_mode="symmetric")
        img_h = jnp.pad(
            img_h, [(0, 0)] * (img.ndim - 1) + [(half, half)], mode="symmetric"
        )
        den = median_label_filter_padded(img_h, cfg.denoise_size, cfg.num_classes)
    else:
        den = img

    lin, base, _ = _linear_ids(den)
    lab, ch_planes = _dist_ccl(den, base, lin, max_iters)
    ccl_converged = ch_planes == 0  # [b_loc]

    particle_local = jnp.sum(
        (den == particle_val).astype(jnp.int32), axis=(-2, -1)
    )
    particle_ct = jax.lax.psum(particle_local, SPACE_AXIS)
    n_comp_local = jnp.sum((lab == lin).astype(jnp.int32), axis=(-2, -1))
    n_comp = jax.lax.psum(n_comp_local, SPACE_AXIS)

    # --- particle fill across shards (labels/analysis.py:95-113 semantics) -
    # The bounded EDT's influence range is ≤ cap rows, so exchanging a
    # cap-row halo and computing locally is exact.
    cap = max(cfg.dilation_radius, cfg.distance_threshold)
    dt2 = cfg.distance_threshold * cfg.distance_threshold
    dr2 = cfg.dilation_radius * cfg.dilation_radius
    filled = den
    overlaps = []
    for sval in cell_vals:
        pm_ext = pad_with_halo(
            filled == particle_val, cap, edge_mode="constant", fill=False
        )
        d2 = edt_sq(pm_ext, cap=cap)[..., cap:-cap, :]
        overlap = (filled == sval) & ((d2 < dt2) | (d2 <= dr2))
        ov_local = jnp.sum(overlap.astype(jnp.int32), axis=(-2, -1))
        overlaps.append(jax.lax.psum(ov_local, SPACE_AXIS))
        filled = jnp.where(overlap, jnp.asarray(particle_val, den.dtype), filled)
    overlap_ct = (
        sum(overlaps)
        if overlaps
        else jnp.zeros(den.shape[:-2], jnp.int32)
    )
    if not with_tables:
        return den, lab, particle_ct, n_comp, filled, overlap_ct, ccl_converged
    extra = ()
    if with_merge or with_analysis:
        # global centroid coordinate sums in the same exact (hi, lo) int32
        # digit split as ops.regionprops (Σrow can exceed int32)
        from particle_col_image_segmentation_tpu.ops.regionprops import (
            HILO_BASE,
        )

        _, _, row_offset = _linear_ids(den)
        rows_g = (
            jax.lax.broadcasted_iota(jnp.int32, den.shape, den.ndim - 2)
            + row_offset
        )
        cols = jax.lax.broadcasted_iota(jnp.int32, den.shape, den.ndim - 1)
        extra = (rows_g // HILO_BASE, rows_g % HILO_BASE,
                 cols // HILO_BASE, cols % HILO_BASE)
    seg, area, class_id, cmp_converged, sums = _compact_and_tables_shard(
        lab, lin, den, base, cfg.max_regions, max_iters, extra=extra
    )
    conv = ccl_converged & cmp_converged
    if not with_merge and not with_analysis:
        return (den, lab, particle_ct, n_comp, filled, overlap_ct,
                conv, seg, area, class_id)
    if with_merge:
        g_ctx, m_conv = _merge_shard(
            den, area, *sums, cfg=cfg, strain_vals=cell_vals,
            max_iters=max_iters,
        )
    else:  # analysis without merge: same placeholder as compute_merge=False
        g_ctx = jnp.full(
            den.shape[:-2] + (len(cell_vals) + 1, cfg.max_regions + 1),
            -1, jnp.int32,
        )
        m_conv = jnp.ones(den.shape[:-2], bool)
    if not with_analysis:
        return (den, lab, particle_ct, n_comp, filled, overlap_ct,
                conv & m_conv, seg, area, class_id, g_ctx)
    # full-analysis extras: bboxes exactly like ops.regionprops.region_props
    # (min r = −max(−r) rides the same segment_max; half-open maxes), with
    # GLOBAL row coordinates and a pmax over the space axis
    R = cfg.max_regions + 1
    _, _, row_offset = _linear_ids(den)
    rows_g = (
        jax.lax.broadcasted_iota(jnp.int32, den.shape, den.ndim - 2)
        + row_offset
    )
    cols_g = jax.lax.broadcasted_iota(jnp.int32, den.shape, den.ndim - 1)

    def maxs_one(s2, rg, cg):
        ids = s2.ravel()
        stacked = jnp.stack(
            [rg.ravel(), cg.ravel(), -rg.ravel(), -cg.ravel()], axis=-1
        )
        return jax.ops.segment_max(stacked, ids, num_segments=R)

    maxs_l = jax.vmap(maxs_one)(seg, rows_g, cols_g)  # [b, R+1, 4]
    maxs = jax.lax.pmax(maxs_l, SPACE_AXIS)
    bbox = jnp.stack(
        [-maxs[..., 2], -maxs[..., 3], maxs[..., 0] + 1, maxs[..., 1] + 1],
        axis=-1,
    )
    overlap_strain = (
        jnp.stack(overlaps, axis=-1)
        if overlaps
        else jnp.zeros(den.shape[:-2] + (0,), jnp.int32)
    )
    sr_hi, sr_lo, sc_hi, sc_lo = sums
    return (den, lab, particle_ct, n_comp, filled, overlap_strain,
            conv & m_conv, seg, area, class_id,
            sr_hi, sr_lo, sc_hi, sc_lo, bbox, g_ctx)


@lru_cache(maxsize=None)
def make_sharded_segment_fn(
    mesh,
    cfg: AnalysisConfig,
    particle_val: int = 2,
    cell_vals=(1,),
    max_iters: int = 128,
    with_tables: bool = False,
    with_merge: bool = False,
):
    """Build the jitted sharded step: [B,H,W] uint8 →
    (den [B,H,W], labels [B,H,W] global-root ids, particle_px [B],
     n_comp [B], filled [B,H,W], overlap_px [B], converged [B]).

    Cached per argument tuple (``cell_vals`` must be hashable, i.e. a
    tuple): repeated factory calls return the SAME jitted object, so
    jit's trace cache hits instead of retracing the whole graph per call.

    ``converged`` is per-plane: False means the distributed fixpoint hit its
    ``max_iters`` budget with labels still changing — the labels/tables for
    that plane are invalid and callers must surface the failure.

    With ``with_tables`` the step additionally returns the same per-region
    outputs as the single-chip fused pass (models/batch.py):
    seg [B,H,W] global compact ids (skimage raster order), area [B,R+1],
    class_id [B,R+1] — tables replicated across the space axis.

    B shards over "data", H over "space"; the full per-plane pipeline
    (denoise → CCL → compaction → tables → particle fill) runs inside one
    shard_map.  ``with_merge`` additionally runs distributed proximity-merge
    grouping and appends ``g_ctx`` (implies ``with_tables``).
    """
    with_tables = with_tables or with_merge
    plane_specs = (
        P(DATA_AXIS, SPACE_AXIS, None),
        P(DATA_AXIS, SPACE_AXIS, None),
        P(DATA_AXIS),
        P(DATA_AXIS),
        P(DATA_AXIS, SPACE_AXIS, None),
        P(DATA_AXIS),
        P(DATA_AXIS),  # converged
    )
    if with_tables:
        plane_specs = plane_specs + (
            P(DATA_AXIS, SPACE_AXIS, None),
            P(DATA_AXIS),
            P(DATA_AXIS),
        )
    if with_merge:
        plane_specs = plane_specs + (P(DATA_AXIS),)  # g_ctx [b, S+1, R+1]
    fn = jax.shard_map(
        partial(
            _segment_shard,
            cfg=cfg,
            particle_val=particle_val,
            cell_vals=tuple(cell_vals),
            max_iters=max_iters,
            with_tables=with_tables,
            with_merge=with_merge,
        ),
        mesh=mesh,
        in_specs=P(DATA_AXIS, SPACE_AXIS, None),
        out_specs=plane_specs,
    )
    return jax.jit(fn)


def make_sharded_analysis_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters: int = 128,
):
    """The FULL sharded per-plane analysis graph — denoise → distributed CCL
    → global compaction + tables → particle fill → proximity-merge grouping
    — in one shard_map (the multi-chip counterpart of
    labels.analysis.analyze_plane_device).  Returns the with_tables outputs
    plus ``g_ctx`` [B, n_strains+1, R+1] merge-group roots (-1 = centroid
    off the dilated mask), identical to the single-chip ``_stage_merge``."""
    return make_sharded_segment_fn(
        mesh, cfg, particle_val=particle_val, cell_vals=tuple(cell_vals),
        max_iters=max_iters, with_tables=True, with_merge=True,
    )


@lru_cache(maxsize=None)
def make_sharded_full_analysis_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters: int = 128, denoise: bool = True, with_merge: bool = True,
):
    """PlaneDeviceOut-grade sharded analysis: [B,H,W] uint8 →
    (den, lab, particle_ct [B], n_comp [B], filled, overlap_strain [B,S],
     converged [B], seg, area [B,R+1], class_id [B,R+1],
     sr_hi, sr_lo, sc_hi, sc_lo [B,R+1 each], bbox [B,R+1,4],
     g_ctx [B,S+1,R+1]) — everything ``labels.analysis.analyze_plane_device``
    computes (full RegionTable incl. exact centroid sums and bboxes,
    per-strain fill overlaps, merge-group roots), every stage
    halo-exchange sharded.  ``denoise=False`` mirrors the reference
    re-analysis paths (tiff_analysis.py:168,206)."""
    plane = P(DATA_AXIS, SPACE_AXIS, None)
    rep = P(DATA_AXIS)
    fn = jax.shard_map(
        partial(
            _segment_shard, cfg=cfg, particle_val=particle_val,
            cell_vals=tuple(cell_vals), max_iters=max_iters,
            with_analysis=True, with_merge=with_merge, denoise=denoise,
        ),
        mesh=mesh,
        in_specs=plane,
        out_specs=(plane, plane, rep, rep, plane, rep, rep, plane,
                   rep, rep, rep, rep, rep, rep, rep, rep),
    )
    return jax.jit(fn)


def sharded_segment_batch(
    batch, mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,)
):
    """Convenience wrapper: run the sharded step on a host batch."""
    fn = make_sharded_segment_fn(mesh, cfg, particle_val, tuple(cell_vals))
    return fn(jnp.asarray(batch))


# ---------------------------------------------------------------------------
# DAPI dedup (labels/analysis.py:dapi_dedup_device, reference :252-287)
# ---------------------------------------------------------------------------


def _dapi_dedup_shard(dapi, other, cfg: AnalysisConfig, max_iters: int):
    dapi_mask = dapi == 1
    other_mask = other == 1
    lin, base, _ = _linear_ids(dapi)
    lab, ch = _dist_ccl(dapi_mask.astype(jnp.uint8), base, lin, max_iters)
    seg, area, _, cmp_conv, (ov,) = _compact_and_tables_shard(
        lab, lin, dapi_mask.astype(jnp.uint8), base, cfg.max_regions,
        max_iters, extra=(other_mask.astype(jnp.int32),),
    )
    R = cfg.max_regions + 1
    frac = ov.astype(jnp.float32) / jnp.maximum(area, 1).astype(jnp.float32)
    remove = (frac > cfg.dapi_overlap_threshold) & (jnp.arange(R)[None] > 0)
    # tables are space-replicated: the pixel lookup is a local [R+1] gather
    b = seg.shape[0]
    rm_px = jnp.take_along_axis(
        remove.astype(jnp.int32), seg.reshape(b, -1), axis=-1
    ).reshape(seg.shape)
    out = jnp.where((rm_px > 0) & dapi_mask, jnp.uint8(2), dapi)
    # global region count so callers can detect table overflow: ranks past
    # max_regions never get a frac row and their seg ids would clamp into
    # region R-1's verdict — silently-wrong without this check
    num = jax.lax.psum(
        jnp.sum((lab == lin).astype(jnp.int32), axis=(-2, -1)), SPACE_AXIS
    )
    return out, num, (ch == 0) & cmp_conv


@lru_cache(maxsize=None)
def make_sharded_dapi_dedup_fn(mesh, cfg: AnalysisConfig, max_iters: int = 128):
    """Sharded DAPI-vs-other-channel dedup: [B,H,W]×2 uint8 →
    (updated dapi [B,H,W], num_regions [B], converged [B]).  Bit-identical
    to the single-chip ``labels.analysis.dapi_dedup_device``: distributed
    CCL on the DAPI cell mask, per-region overlap fractions psum'd over the
    space axis, regions above ``cfg.dapi_overlap_threshold`` rewritten to
    value 2.  Callers must check ``num_regions <= cfg.max_regions`` — an
    overflowing plane's extra regions get no overlap row and their verdicts
    are invalid (same contract as the fused segmentation's overflow flag)."""
    fn = jax.shard_map(
        partial(_dapi_dedup_shard, cfg=cfg, max_iters=max_iters),
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, SPACE_AXIS, None),
            P(DATA_AXIS, SPACE_AXIS, None),
        ),
        out_specs=(
            P(DATA_AXIS, SPACE_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
        ),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# watershed (ops/watershed.py two-phase flooding, reference
# refine_boundaries.py:73)
# ---------------------------------------------------------------------------


def _ws_pad(x, fill):
    """1-px halo on rows (ppermute exchange) and columns (local fill)."""
    xp = pad_with_halo(x, 1, edge_mode="constant", fill=fill)
    return jnp.pad(
        xp, [(0, 0)] * (x.ndim - 1) + [(1, 1)], constant_values=fill
    )


def _watershed_shard(image, markers, mask, connectivity: int, max_iters: int):
    """Distributed two-phase watershed: the same minimax-cost and claim
    fixpoints as ops/watershed.py (one shared candidate/fold definition),
    with a 1-px halo exchange per iteration and psum convergence.  The
    unique-fixpoint argument makes the sharded schedule bit-identical to
    the single-device kernel."""
    from particle_col_image_segmentation_tpu.ops.watershed import (
        _BIG_LAB as BIG,
        _offsets,
        claim_candidates,
        fold_claim,
    )

    img = image.astype(jnp.float32)
    lab0 = markers.astype(jnp.int32)
    m = mask.astype(bool)
    seeded = (lab0 > 0) & m
    cost0 = jnp.where(seeded, img, jnp.float32(_FINF))
    offsets = _offsets(connectivity)
    shape = img.shape
    h_loc, W = shape[-2:]

    def _sl(xp, dy, dx):
        return xp[..., 1 + dy : 1 + dy + h_loc, 1 + dx : 1 + dx + W]

    def _changed(new_old_pairs):
        ch_pl = jnp.zeros(shape[:-2], jnp.int32)
        for new, old in new_old_pairs:
            ch_pl = ch_pl + jnp.any(new != old, axis=(-2, -1)).astype(jnp.int32)
        ch_planes = jax.lax.psum(ch_pl, SPACE_AXIS)
        changed = jax.lax.psum(
            jax.lax.psum(jnp.any(ch_planes > 0).astype(jnp.int32), SPACE_AXIS),
            DATA_AXIS,
        )
        return ch_planes, changed > 0

    # ---- phase 1: minimax costs (halo-exchanged Jacobi) ---------------
    def cost_body(state):
        cost, _, _, i = state
        cp = _ws_pad(cost, _FINF)
        best = cost
        for dy, dx in offsets:
            best = jnp.minimum(best, jnp.maximum(_sl(cp, dy, dx), img))
        new = jnp.where(
            seeded, cost0, jnp.where(m, best, jnp.float32(_FINF))
        )
        ch_planes, changed = _changed([(new, cost)])
        return new, ch_planes, changed, i + 1

    def cond(state):
        _, _, changed, i = state
        return changed & (i < max_iters)

    # inputs are already data-varying, so the carries are too; only the
    # shape-derived change counter needs explicit vma marking
    ch0 = jax.lax.pcast(
        jnp.ones(shape[:-2], jnp.int32), (DATA_AXIS,), to="varying"
    )
    cost, c_ch, _, _ = jax.lax.while_loop(
        cond, cost_body, (cost0, ch0, jnp.bool_(True), 0)
    )

    # ---- phase 2: claim relaxation (recompute, halo-exchanged) --------
    neg = jnp.float32(-_FINF)
    lab_i = jnp.where(seeded, lab0, BIG)
    dist_i = jnp.where(seeded, 0, BIG)
    eimg_i = jnp.where(seeded, neg, jnp.float32(_FINF))
    cost_p = _ws_pad(cost, _FINF)
    img_p = _ws_pad(img, _FINF)

    def lab_body(state):
        lab, dist, eimg, _, _, i = state
        lp = _ws_pad(lab, BIG)
        dp = _ws_pad(dist, BIG)
        ep = _ws_pad(eimg, _FINF)
        pads = {id(cost): cost_p, id(img): img_p, id(lab): lp,
                id(dist): dp, id(eimg): ep}

        def shifted(x, dy, dx, fill):
            del fill  # pad constants already encode the per-array fills
            return _sl(pads[id(x)], dy, dx)

        best = (
            jnp.full(shape, BIG, jnp.int32),
            jnp.full(shape, _FINF, jnp.float32),
            jnp.full(shape, _FINF, jnp.float32),
            jnp.full(shape, BIG, jnp.int32),
        )
        for dy, dx in offsets:
            best = fold_claim(
                best,
                claim_candidates(cost, img, lab, dist, eimg, dy, dx, shifted),
            )
        bd, be, _, bl = best
        new_l = jnp.where(seeded, lab0, jnp.where(m, bl, BIG))
        new_d = jnp.where(seeded, 0, jnp.where(m, bd, BIG))
        new_e = jnp.where(seeded, neg, jnp.where(m, be, jnp.float32(_FINF)))
        ch_planes, changed = _changed(
            [(new_l, lab), (new_d, dist), (new_e, eimg)]
        )
        return new_l, new_d, new_e, ch_planes, changed, i + 1

    def lab_cond(state):
        _, _, _, _, changed, i = state
        return changed & (i < max_iters)

    lab, _, _, l_ch, _, _ = jax.lax.while_loop(
        lab_cond, lab_body,
        (lab_i, dist_i, eimg_i, ch0, jnp.bool_(True), 0),
    )
    reached = m & (cost < _FINF) & (lab != BIG)
    out = jnp.where(reached, lab, 0)
    return out, (c_ch == 0) & (l_ch == 0)


# ---------------------------------------------------------------------------
# refine pipeline (models/refine.refine_plane_device, spatially sharded —
# reference refine_boundaries.py end to end on a mesh)
# ---------------------------------------------------------------------------


def _edt_sq_exact_shard(feature, rows_per_step: int = 128):
    """Distributed exact squared EDT (ops.edt.edt_sq_exact semantics,
    bit-identical).

    Phase 1 (per-row horizontal distances) is fully shard-local — rows live
    whole on a shard.  Phase 2's min-plus needs EVERY row's phase-1 plane:
    one all_gather over the space axis ships the [H_global, W] int32 dh²
    image (16 MB at 2048², once — not per iteration), then each shard
    min-pluses only its own band's output rows (``minplus_rows`` with
    global row indices), keeping the O(H²·W) work evenly sharded.
    """
    h_loc, W = feature.shape[-2:]
    n = jax.lax.axis_size(SPACE_AXIS)
    Hg = n * h_loc
    inf = jnp.int32((Hg + W + 2) * (Hg + W + 2))  # = single-chip inf
    dh2 = row_dh2_exact(feature, inf)
    g = jax.lax.all_gather(dh2, SPACE_AXIS)  # [n, ..., h_loc, W]
    g = jnp.moveaxis(g, 0, -3).reshape(feature.shape[:-2] + (Hg, W))
    row0 = jax.lax.axis_index(SPACE_AXIS) * h_loc
    r_idx = row0 + jnp.arange(h_loc, dtype=jnp.int32)
    return minplus_rows(g, r_idx, inf, rows_per_step)


def _local_maxima_shard(img, max_iters: int):
    """Distributed plateau-aware local maxima (ops.morphology.local_maxima
    semantics, 8-conn): halo'd neighbor compares seed the "bad" set, which
    floods through equal-value plateaus via in-band segmented OR scans +
    per-iteration 1-px halo exchange (a plateau spanning k bands converges
    in ~k iterations); psum convergence, per-plane flags."""
    shape = img.shape
    h_loc, W = shape[-2:]
    if jnp.issubdtype(img.dtype, jnp.floating):
        low = img.dtype.type(-jnp.inf)
    else:
        low = jnp.iinfo(img.dtype).min
    img_p = _ws_pad(img, low)  # below-everything: borders never "higher"

    def _sl(xp, dy, dx):
        return xp[..., 1 + dy : 1 + dy + h_loc, 1 + dx : 1 + dx + W]

    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1),
               (-1, -1), (-1, 1), (1, -1), (1, 1)]
    has_higher = jnp.zeros(shape, bool)
    eqs = []  # plateau-equality masks, fixed under the flood
    for dy, dx in offsets:
        nb = _sl(img_p, dy, dx)
        has_higher = has_higher | (nb > img)
        eqs.append(nb == img)

    same_row = jnp.concatenate(
        [jnp.zeros(shape[:-1] + (1,), bool),
         img[..., :, 1:] == img[..., :, :-1]], axis=-1,
    )
    same_col = jnp.concatenate(
        [jnp.zeros(shape[:-2] + (1, W), bool),
         img[..., 1:, :] == img[..., :-1, :]], axis=-2,
    )

    def body(state):
        bad, _, _, i = state
        bad_p = _ws_pad(bad, False)
        new = bad
        for eq, (dy, dx) in zip(eqs, offsets):
            new = new | (_sl(bad_p, dy, dx) & eq)
        new = new | seg_or_scan_bidi(new, same_row, axis=-1)
        new = new | seg_or_scan_bidi(new, same_col, axis=-2)
        ch_planes = jax.lax.psum(
            jnp.any(new != bad, axis=(-2, -1)).astype(jnp.int32), SPACE_AXIS
        )
        changed = jax.lax.psum(
            jax.lax.psum(jnp.any(ch_planes > 0).astype(jnp.int32), SPACE_AXIS),
            DATA_AXIS,
        )
        return new, ch_planes, changed > 0, i + 1

    def cond(state):
        _, _, changed, i = state
        return changed & (i < max_iters)

    ch0 = jax.lax.pcast(
        jnp.ones(shape[:-2], jnp.int32), (DATA_AXIS,), to="varying"
    )
    bad, ch_planes, _, _ = jax.lax.while_loop(
        cond, body, (has_higher, ch0, jnp.bool_(True), 0)
    )
    return ~bad, ch_planes == 0


def _refine_shard(bm, threshold: float, connectivity: int, max_regions: int,
                  max_iters: int, with_tables: bool = False):
    binary = bm < threshold  # reference :44-45
    # int32 d² feeds the maxima (monotone-equivalent to d, exact — matches
    # models/refine.refine_plane_device for bit-parity)
    maxima, conv_max = _local_maxima_shard(
        _edt_sq_exact_shard(~binary), max_iters
    )
    lin, base, _ = _linear_ids(bm)
    lab, ch = _dist_ccl(maxima.astype(jnp.uint8), base, lin, max_iters)
    markers, _, _, conv_cmp, _ = _compact_and_tables_shard(
        lab, lin, maxima.astype(jnp.uint8), base, max_regions, max_iters,
        fg=maxima,
    )
    num = jax.lax.psum(
        jnp.sum(((lab == lin) & maxima).astype(jnp.int32), axis=(-2, -1)),
        SPACE_AXIS,
    )
    labels, conv_ws = _watershed_shard(
        bm.astype(jnp.float32), markers, binary, connectivity, max_iters
    )
    converged = conv_max & (ch == 0) & conv_cmp & conv_ws
    if not with_tables:
        return labels, markers, num, converged
    # per-cell area + exact centroid coordinate sums over the FINAL labels
    # (the single-chip path's region_props table, ops/regionprops.py):
    # shard-local segment sums with GLOBAL row coordinates, psum'd over the
    # space axis; (hi, lo) base-split keeps Σrow exact in int32
    from particle_col_image_segmentation_tpu.ops.regionprops import HILO_BASE

    R = max_regions + 1
    _, _, row_offset = _linear_ids(bm)
    rows_g = (
        jax.lax.broadcasted_iota(jnp.int32, bm.shape, bm.ndim - 2) + row_offset
    )
    cols_g = jax.lax.broadcasted_iota(jnp.int32, bm.shape, bm.ndim - 1)

    def tables_one(s2, rg, cg):
        ids = s2.ravel()
        stacked = jnp.stack(
            [jnp.ones_like(ids), rg.ravel() // HILO_BASE,
             rg.ravel() % HILO_BASE, cg.ravel() // HILO_BASE,
             cg.ravel() % HILO_BASE],
            axis=-1,
        )
        return jax.ops.segment_sum(stacked, ids, num_segments=R)

    sums_l = jax.vmap(tables_one)(labels, rows_g, cols_g)  # [b, R+1, 5]
    sums = jax.lax.psum(sums_l, SPACE_AXIS)
    return labels, markers, num, converged, sums


@lru_cache(maxsize=None)
def make_sharded_refine_fn(mesh, threshold: float = 0.5,
                           connectivity: int = 1, max_regions: int = 4095,
                           max_iters: int = 4096, with_tables: bool = False):
    """The FULL refine pipeline on a mesh: probability maps [B, H, W] →
    (labels [B,H,W], markers [B,H,W], num_cells [B], converged [B]).

    EDT → plateau-aware local maxima → distributed CCL → raster-rank
    marker compaction → two-phase watershed, every stage halo-exchange
    sharded — per-plane results bit-identical to the single-chip
    ``models.refine.refine_plane_device`` (tested on the 8-virtual-device
    CPU mesh).  Callers must check ``num_cells <= max_regions`` and
    ``converged`` (same contracts as the single-chip path).

    ``with_tables`` appends ``sums`` [B, max_regions+1, 5] — per-cell
    (area, Σrow hi, Σrow lo, Σcol hi, Σcol lo) over the final labels,
    replicated across the space axis — enough to reconstruct the per-cell
    areas/centroids the refine CSV needs (the stated reference goals,
    refine_boundaries.py:2-12)."""
    out_specs = (
        P(DATA_AXIS, SPACE_AXIS, None),
        P(DATA_AXIS, SPACE_AXIS, None),
        P(DATA_AXIS),
        P(DATA_AXIS),
    )
    if with_tables:
        out_specs = out_specs + (P(DATA_AXIS),)
    fn = jax.shard_map(
        partial(_refine_shard, threshold=threshold,
                connectivity=connectivity, max_regions=max_regions,
                max_iters=max_iters, with_tables=with_tables),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, SPACE_AXIS, None),),
        out_specs=out_specs,
    )
    return jax.jit(fn)


@lru_cache(maxsize=None)
def make_sharded_watershed_fn(mesh, connectivity: int = 1,
                              max_iters: int = 4096):
    """Sharded marker watershed: (image [B,H,W] f32, markers [B,H,W] i32,
    mask [B,H,W] bool) → (labels [B,H,W] i32, converged [B]).  Bit-identical
    to ops.watershed.watershed on every plane (unique two-phase fixpoint)."""
    fn = jax.shard_map(
        partial(_watershed_shard, connectivity=connectivity,
                max_iters=max_iters),
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, SPACE_AXIS, None),
            P(DATA_AXIS, SPACE_AXIS, None),
            P(DATA_AXIS, SPACE_AXIS, None),
        ),
        out_specs=(P(DATA_AXIS, SPACE_AXIS, None), P(DATA_AXIS)),
    )
    return jax.jit(fn)
