"""Device-side region analytics: the fused per-plane analysis graph.

One jit-compiled function does *all* O(H·W) work for a plane — denoise, CCL,
region properties, particle fill, proximity-merge grouping inputs, DAPI
dedup — so a plane crosses the host↔device boundary exactly twice (upload
raw labels, download compact tables + images).  The O(regions) bookkeeping
(dict assembly, CSV ordering) stays on host where it is negligible.

Reference counterparts: tiff_analysis.py:742-789 (positions/areas),
:826-883 (merge), :931-1015 (particle fill), :252-287 (DAPI dedup).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.config import AnalysisConfig, CELL_TYPES
from particle_col_image_segmentation_tpu.ops import (
    RegionTable,
    centroids_int,
    compact_labels,
    connected_components,
    dilate_disk,
    edt_sq,
    median_label_filter,
    region_props,
    table_lookup,
)

__all__ = [
    "PlaneDeviceOut",
    "analyze_plane_device",
    "analyze_planes_device",
    "analyze_plane_device_sharded",
    "dapi_dedup_device",
    "split_plane_device_out",
    "strain_values_of",
]


class PlaneDeviceOut(NamedTuple):
    den: jnp.ndarray  # [H,W] denoised label plane
    seg: jnp.ndarray  # [H,W] compact component ids (1..n, raster order)
    num: jnp.ndarray  # scalar int32: true component count
    table: RegionTable  # [R+1] region properties
    particle_area: jnp.ndarray  # scalar int32: particle pixels pre-fill
    filled: jnp.ndarray  # [H,W] plane after particle fill
    overlap_counts: jnp.ndarray  # [n_strains] int32 absorbed px per strain
    g_ctx: jnp.ndarray  # [n_strains+1, R+1] merge-group root per region
    #   (contexts: each strain in map order, then the combined union;
    #    -1 = centroid not on any dilated component)
    converged: jnp.ndarray  # scalar bool: every fixpoint kernel reached its
    #   fixpoint within budget; False ⇒ labels/tables are invalid


def strain_values_of(cell_types: Tuple[Tuple[int, str], ...]):
    """(value, name) pairs of strain classes, in map (value) order."""
    return tuple((v, n) for v, n in cell_types if n in CELL_TYPES)


def _particle_value(cell_types):
    for v, n in cell_types:
        if n == "Particle":
            return v
    raise ValueError("cell_types has no Particle class")


@partial(jax.jit, static_argnames=("cfg", "denoise", "particle_val"))
def _stage_segment(img, cfg: AnalysisConfig, denoise: bool, particle_val: int):
    with jax.named_scope("median"):
        den = (
            median_label_filter(img, cfg.denoise_size, cfg.num_classes)
            if denoise
            else img
        )
    with jax.named_scope("ccl"):
        raw, converged = connected_components(
            den, background=None, num_classes=cfg.num_classes,
            with_flag=True, max_iters=cfg.ccl_max_iters,
        )
    with jax.named_scope("compact"):
        seg, num = compact_labels(raw, cfg.max_regions)
    with jax.named_scope("tables"):
        table = region_props(seg, den, cfg.max_regions)
    # per-plane sum so the stage is batch-polymorphic ([H,W] and [B,H,W])
    particle_area = jnp.sum((den == particle_val).astype(jnp.int32),
                            axis=(-2, -1))
    return den, seg, num, table, particle_area, converged


@partial(jax.jit, static_argnames=("cfg", "particle_val", "strain_vals"))
@jax.named_scope("fill")
def _stage_fill(den, cfg: AnalysisConfig, particle_val: int, strain_vals):
    # Sequential over strains on purpose: pixels absorbed for strain k expand
    # the particle mask seen by strain k+1, exactly as the reference's loop
    # reassigns ds_arr each iteration (tiff_analysis.py:931-1015).  Each
    # strain's overlap is one capped EDT of the particle mask, thresholded
    # with the reference's two OR-ed tests (squared-int exact).
    cap = max(cfg.dilation_radius, cfg.distance_threshold)
    dt2 = cfg.distance_threshold * cfg.distance_threshold
    dr2 = cfg.dilation_radius * cfg.dilation_radius
    filled = den
    overlaps = []
    for sval in strain_vals:
        d2 = edt_sq(filled == particle_val, cap=cap)
        overlap = (filled == sval) & ((d2 < dt2) | (d2 <= dr2))
        overlaps.append(jnp.sum(overlap.astype(jnp.int32), axis=(-2, -1)))
        filled = jnp.where(
            overlap, jnp.asarray(particle_val, filled.dtype), filled
        )
    # [n_strains] for [H,W] input, [n_strains, B] for [B,H,W]
    overlap_counts = (
        jnp.stack(overlaps)
        if overlaps
        else jnp.zeros((0,) + den.shape[:-2], jnp.int32)
    )
    return filled, overlap_counts


@partial(jax.jit, static_argnames=("cfg", "strain_vals"))
@jax.named_scope("merge")
def _stage_merge(den, table: RegionTable, cfg: AnalysisConfig, strain_vals):
    # For each context (each strain's class mask, then the union of all
    # strain masks): dilate by disk(r), label, and read the component root
    # under every region's truncated centroid (tiff_analysis.py:826-851).
    # Host groups regions by root.
    H, W = den.shape
    icy, icx = centroids_int(table)
    icy = jnp.clip(icy, 0, H - 1)
    icx = jnp.clip(icx, 0, W - 1)
    masks = [den == sval for sval in strain_vals]
    union = jnp.zeros((H, W), bool)
    for m in masks:
        union = union | m
    ctx_masks = jnp.stack(masks + [union])
    dil = dilate_disk(ctx_masks, cfg.merge_disk_radius)
    # background=None keeps the CCL on the uint8 value path (bg pixels get
    # inert labels); centroids off the dilated mask map to -1 below, exactly
    # as background=0's -1 labels did
    ctx_raw, conv = connected_components(
        dil.astype(jnp.uint8), background=None, num_classes=2, with_flag=True,
        max_iters=cfg.ccl_max_iters,
    )
    # one flat 1-D gather per context
    S = ctx_raw.shape[0]
    flat_idx = jnp.broadcast_to((icy * W + icx)[None, :], (S, icy.shape[0]))
    g = jnp.take_along_axis(ctx_raw.reshape(S, H * W), flat_idx, axis=-1)
    on_mask = jnp.take_along_axis(
        dil.reshape(S, H * W).astype(jnp.int32), flat_idx, axis=-1
    )
    return jnp.where(on_mask > 0, g, -1), jnp.all(conv)


@partial(jax.jit, static_argnames=("cfg", "strain_vals"))
@jax.named_scope("merge")
def _stage_merge_batch(den, table: RegionTable, cfg: AnalysisConfig,
                       strain_vals):
    """_stage_merge for a [B, H, W] stack: the S·B context planes label in
    ONE flattened CCL launch; gathers are per (context, plane).  Returns
    (g_ctx [S, B, R+1], converged [B])."""
    B, H, W = den.shape
    icy, icx = centroids_int(table)  # [B, R+1] each
    icy = jnp.clip(icy, 0, H - 1)
    icx = jnp.clip(icx, 0, W - 1)
    masks = [den == sval for sval in strain_vals]  # each [B, H, W]
    union = jnp.zeros((B, H, W), bool)
    for m in masks:
        union = union | m
    ctx_masks = jnp.stack(masks + [union])  # [S, B, H, W]
    S = ctx_masks.shape[0]
    flat = ctx_masks.reshape(S * B, H, W)
    dil = dilate_disk(flat, cfg.merge_disk_radius)
    ctx_raw, conv = connected_components(
        dil.astype(jnp.uint8), background=None, num_classes=2, with_flag=True,
        max_iters=cfg.ccl_max_iters,
    )
    R1 = icy.shape[-1]
    flat_idx = jnp.broadcast_to(
        (icy * W + icx)[None], (S, B, R1)
    ).reshape(S * B, R1)
    g = jnp.take_along_axis(ctx_raw.reshape(S * B, H * W), flat_idx, axis=-1)
    on_mask = jnp.take_along_axis(
        dil.reshape(S * B, H * W).astype(jnp.int32), flat_idx, axis=-1
    )
    g_ctx = jnp.where(on_mask > 0, g, -1).reshape(S, B, R1)
    conv_b = jnp.reshape(conv, (S, B)).all(axis=0)
    return g_ctx, conv_b


def analyze_plane_device(
    img: jnp.ndarray,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """Full device analysis of one label plane.

    Orchestrates three separately-jitted stages — segment, particle fill,
    merge-grouping — with device-resident intermediates.  The split keeps
    each compile tractable (one fused graph of everything strains the
    compiler) and lets stages cache across cell-type variants; it can also
    be wrapped in an outer jit for a fully fused graph on small planes.

    Args:
      img: [H, W] small-int class plane (raw, pre-denoise).
      cell_types: static tuple of (pixel value, class name) in value order.
      cfg: static AnalysisConfig.
      compute_merge: also compute proximity-merge grouping inputs
        (reference ``merged=True`` path).
      denoise: median-filter first. False for planes that are already
        denoised (the reference's deduped-DAPI and fused-channel re-analyses
        at tiff_analysis.py:168,206 skip the filter).
    """
    strain_pairs = strain_values_of(cell_types)
    strain_vals = tuple(v for v, _ in strain_pairs)
    particle_val = _particle_value(cell_types)

    img = jnp.asarray(img)
    den, seg, num, table, particle_area, conv = _stage_segment(
        img, cfg=cfg, denoise=denoise, particle_val=particle_val
    )
    filled, overlap_counts = _stage_fill(
        den, cfg=cfg, particle_val=particle_val, strain_vals=strain_vals
    )
    if compute_merge:
        g_ctx, conv_merge = _stage_merge(
            den, table, cfg=cfg, strain_vals=strain_vals
        )
        conv = conv & conv_merge
    else:
        g_ctx = jnp.full(
            (len(strain_vals) + 1, cfg.max_regions + 1), -1, jnp.int32
        )

    return PlaneDeviceOut(
        den=den,
        seg=seg,
        num=num,
        table=table,
        particle_area=particle_area,
        filled=filled,
        overlap_counts=overlap_counts,
        g_ctx=g_ctx,
        converged=conv,
    )


def analyze_planes_device(
    imgs: jnp.ndarray,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """``analyze_plane_device`` for a same-shape plane STACK [B, H, W] —
    the reference's outermost parallel axis (its folder loop,
    tiff_analysis.py:1126-1134) batched into single device dispatches.

    Every stage is the same batch-polymorphic kernel family the batched
    refine graph uses, so per-plane results are bit-identical to B
    separate ``analyze_plane_device`` calls (byte-identical folder CSVs,
    tested); only dispatch count and device utilization change.  Leaves of
    the returned PlaneDeviceOut carry a leading batch axis (overlap_counts
    is [n_strains, B], g_ctx is [S, B, R+1]); slice per plane with
    ``split_plane_device_out``.
    """
    strain_pairs = strain_values_of(cell_types)
    strain_vals = tuple(v for v, _ in strain_pairs)
    particle_val = _particle_value(cell_types)

    imgs = jnp.asarray(imgs)
    if imgs.ndim != 3:
        raise ValueError(f"expected [B, H, W], got {imgs.shape}")
    den, seg, num, table, particle_area, conv = _stage_segment(
        imgs, cfg=cfg, denoise=denoise, particle_val=particle_val
    )
    filled, overlap_counts = _stage_fill(
        den, cfg=cfg, particle_val=particle_val, strain_vals=strain_vals
    )
    if compute_merge:
        g_ctx, conv_merge = _stage_merge_batch(
            den, table, cfg=cfg, strain_vals=strain_vals
        )
        conv = conv & conv_merge
    else:
        g_ctx = jnp.full(
            (len(strain_vals) + 1, imgs.shape[0], cfg.max_regions + 1),
            -1, jnp.int32,
        )

    return PlaneDeviceOut(
        den=den, seg=seg, num=num, table=table,
        particle_area=particle_area, filled=filled,
        overlap_counts=overlap_counts, g_ctx=g_ctx, converged=conv,
    )


def split_plane_device_out(out: PlaneDeviceOut, b: int) -> PlaneDeviceOut:
    """Plane ``b`` of a batched ``analyze_planes_device`` result, in the
    single-plane layout ``analyze_plane`` consumes."""
    return PlaneDeviceOut(
        den=out.den[b],
        seg=out.seg[b],
        num=out.num[b],
        table=RegionTable(*(leaf[b] for leaf in out.table)),
        particle_area=out.particle_area[b],
        filled=out.filled[b],
        overlap_counts=out.overlap_counts[:, b],
        g_ctx=out.g_ctx[:, b],
        converged=out.converged[b],
    )


def analyze_plane_device_sharded(
    img: jnp.ndarray,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    mesh,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """``analyze_plane_device`` on a device mesh: plane rows shard across
    the "space" axis (halo-exchanged distributed CCL / tables / fill /
    merge, parallel.sharded), removing the single-chip plane-size ceiling
    for the MAIN analysis path.  Returns the same PlaneDeviceOut —
    seg/table/fill/overlaps bit-identical to the single-chip graph;
    ``g_ctx`` root VALUES come from the distributed CCL (different ids,
    identical grouping partition, which is all the host consumes)."""
    from particle_col_image_segmentation_tpu.parallel.sharded import (
        make_sharded_full_analysis_fn,
    )

    from particle_col_image_segmentation_tpu.parallel.mesh import DATA_AXIS

    if mesh.shape[DATA_AXIS] != 1:
        raise ValueError(
            f"analyze shards ONE plane at a time: the mesh data axis must "
            f"be 1, got {dict(mesh.shape)} — build it with "
            "make_mesh(n_data=1, n_space=N) (use models.batch.run_batch "
            "for data-parallel many-plane runs)"
        )
    strain_pairs = strain_values_of(cell_types)
    strain_vals = tuple(v for v, _ in strain_pairs)
    particle_val = _particle_value(cell_types)
    fn = make_sharded_full_analysis_fn(
        mesh, cfg, particle_val=particle_val, cell_vals=strain_vals,
        max_iters=cfg.sharded_max_iters, denoise=denoise,
        with_merge=compute_merge,
    )
    (den, _, particle_ct, n_comp, filled, overlap_strain, conv, seg,
     area, class_id, sr_hi, sr_lo, sc_hi, sc_lo, bbox, g_ctx) = fn(
        jnp.asarray(img)[None]
    )
    R = cfg.max_regions + 1
    table = RegionTable(
        area=area[0],
        sr_hi=sr_hi[0],
        sr_lo=sr_lo[0],
        sc_hi=sc_hi[0],
        sc_lo=sc_lo[0],
        bbox=bbox[0],
        class_id=class_id[0],
        valid=(area[0] > 0) & (jnp.arange(R) > 0),
    )
    return PlaneDeviceOut(
        den=den[0],
        seg=seg[0],
        num=n_comp[0],
        table=table,
        particle_area=particle_ct[0],
        filled=filled[0],
        overlap_counts=overlap_strain[0],
        g_ctx=g_ctx[0],
        converged=conv[0],
    )


@partial(jax.jit, static_argnames=("cfg",))
@jax.named_scope("dedup")
def dapi_dedup_device(
    dapi: jnp.ndarray, other: jnp.ndarray, cfg: AnalysisConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Remove DAPI cells overlapping the other channel's cells
    (reference :252-287, vectorized: per-region overlap via segment sums).

    Cells (value 1) whose component overlaps the other channel's cell mask by
    more than ``cfg.dapi_overlap_threshold`` of their area become value 2.

    Returns (updated plane, converged bool scalar).
    """
    dapi_mask = dapi == 1
    other_mask = other == 1
    # background=None: bg pixels form (inert) labeled components too, which
    # keeps the whole CCL on the cheap uint8 value path — the removal test
    # is masked by dapi_mask below, so bg rows in the tables never act
    raw, converged = connected_components(
        dapi_mask.astype(jnp.uint8), background=None, num_classes=2,
        with_flag=True, max_iters=cfg.ccl_max_iters,
    )
    seg, _ = compact_labels(raw, cfg.max_regions)
    R = cfg.max_regions + 1
    ids = seg.ravel()
    area = jax.ops.segment_sum(jnp.ones_like(ids), ids, num_segments=R)
    ov = jax.ops.segment_sum(
        other_mask.ravel().astype(jnp.int32), ids, num_segments=R
    )
    frac = ov.astype(jnp.float32) / jnp.maximum(area, 1).astype(jnp.float32)
    remove = (frac > cfg.dapi_overlap_threshold) & (jnp.arange(R) > 0)
    remove_px = (table_lookup(seg, remove.astype(jnp.int32)) > 0) & dapi_mask
    return jnp.where(remove_px, jnp.uint8(2), dapi), converged
