"""Region properties via segment reductions.

Replaces the reference's skimage ``regionprops`` Python loop
(tiff_analysis.py:746-773) with fixed-shape ``jax.ops.segment_*`` reductions
over compact label ids: area = count, centroid = Σcoords/area,
bbox = per-segment min/max, class = per-segment max of the (component-
homogeneous) class image.  Everything is static-shaped for jit: tables have
``max_regions + 1`` rows, row 0 being the background segment.  Every table
function also takes a [B, H, W] stack and returns [B, R+1] columns.

Precision note: Σrow over a 2048² component can reach ~8.6e9, overflowing
int32 and losing float32 ulps.  Coordinate sums are therefore kept as exact
(hi, lo) int32 pairs with total = HILO_BASE·hi + lo; ``centroids_int`` floors
the exact quotient on device (for the reference's truncated-centroid lookups)
and ``centroids_f64`` reconstructs exact float64 centroids on host (ROI float
parity ≤1e-6 per BASELINE.json).  Overflow check at base 128: lo-sums
≤ 4.2e6·127 ≈ 5.3e8 and the floor-div intermediate 128·r1 + lo ≤ 1.1e9,
both < 2³¹.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "HILO_BASE",
    "RegionTable",
    "CentroidTable",
    "region_props",
    "region_counts",
    "centroid_sums",
    "table_lookup",
    "centroids_int",
    "centroids_f64",
]

HILO_BASE = 128  # (hi, lo) digit base of the exact coordinate sums


class RegionTable(NamedTuple):
    """Fixed-size per-region property table; row 0 = background/padding."""

    area: jnp.ndarray  # [R+1] int32
    sr_hi: jnp.ndarray  # [R+1] int32   Σrow = HILO_BASE*sr_hi + sr_lo (exact)
    sr_lo: jnp.ndarray  # [R+1] int32
    sc_hi: jnp.ndarray  # [R+1] int32   Σcol = HILO_BASE*sc_hi + sc_lo (exact)
    sc_lo: jnp.ndarray  # [R+1] int32
    bbox: jnp.ndarray  # [R+1, 4] int32 (minr, minc, maxr, maxc) half-open
    class_id: jnp.ndarray  # [R+1] int32 pixel value of the component
    valid: jnp.ndarray  # [R+1] bool (area>0 and not background row)


class CentroidTable(NamedTuple):
    """Area + exact (hi, lo) centroid sums only — the 5 columns the refine
    pipeline consumes (``centroids_f64`` duck-types on these fields).  A
    full ``RegionTable`` also carries bbox extremes and the class channel,
    which cost a second (transposed) table pass the refine graph never
    reads (refine cells are all class 1)."""

    area: jnp.ndarray  # [..., R+1] int32
    sr_hi: jnp.ndarray  # [..., R+1] int32   Σrow = HILO_BASE*sr_hi + sr_lo
    sr_lo: jnp.ndarray  # [..., R+1] int32
    sc_hi: jnp.ndarray  # [..., R+1] int32   Σcol = HILO_BASE*sc_hi + sc_lo
    sc_lo: jnp.ndarray  # [..., R+1] int32


@partial(jax.jit, static_argnames=("max_regions",))
def centroid_sums(seg: jnp.ndarray, max_regions: int) -> CentroidTable:
    """CentroidTable from compact ids ``seg`` [H, W] or [B, H, W]
    (0 = background): one fused 5-column segment_sum."""
    if seg.ndim == 3:
        return jax.vmap(partial(centroid_sums, max_regions=max_regions))(seg)
    H, W = seg.shape
    R = max_regions + 1
    ids = seg.ravel()
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).ravel()
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).ravel()
    add_cols = jnp.stack(
        [
            jnp.ones_like(ids),
            rows // HILO_BASE,
            rows % HILO_BASE,
            cols // HILO_BASE,
            cols % HILO_BASE,
        ],
        axis=-1,
    )
    sums = jax.ops.segment_sum(add_cols, ids, num_segments=R)
    return CentroidTable(*(sums[:, k] for k in range(5)))


def _exact_floor_div(hi: jnp.ndarray, lo: jnp.ndarray, d: jnp.ndarray):
    """floor((HILO_BASE*hi + lo) / d) in pure int32 (d ≥ 1; see module
    precision note for the no-overflow argument)."""
    q1 = hi // d
    r1 = hi - q1 * d
    t = HILO_BASE * r1 + lo
    q2 = t // d
    return HILO_BASE * q1 + q2


@partial(jax.jit, static_argnames=("max_regions",))
def region_props(seg: jnp.ndarray, img: jnp.ndarray, max_regions: int) -> RegionTable:
    """Compute RegionTable from compact ids ``seg`` (0 = background) and the
    class image ``img``, each [H, W] or [B, H, W].

    All reductions ride two fused scatters (one add, one max of stacked
    columns) instead of nine separate segment ops: each scatter pass reads
    every id once.
    """
    if seg.ndim == 3:
        return jax.vmap(partial(region_props, max_regions=max_regions))(
            seg, img
        )
    H, W = seg.shape
    R = max_regions + 1
    ids = seg.ravel()
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).ravel()
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).ravel()

    add_cols = jnp.stack(
        [
            jnp.ones_like(ids),
            rows // HILO_BASE,
            rows % HILO_BASE,
            cols // HILO_BASE,
            cols % HILO_BASE,
        ],
        axis=-1,
    )
    sums = jax.ops.segment_sum(add_cols, ids, num_segments=R)
    area, sr_hi, sr_lo, sc_hi, sc_lo = (sums[:, k] for k in range(5))

    # bbox mins ride the same scatter-max as the maxes (min r = −max(−r))
    maxs = jax.ops.segment_max(
        jnp.stack(
            [rows, cols, img.ravel().astype(jnp.int32), -rows, -cols], axis=-1
        ),
        ids,
        num_segments=R,
    )
    bbox = jnp.stack(
        [-maxs[:, 3], -maxs[:, 4], maxs[:, 0] + 1, maxs[:, 1] + 1], axis=-1
    )
    class_id = maxs[:, 2]
    valid = (area > 0) & (jnp.arange(R) > 0)
    return RegionTable(
        area=area,
        sr_hi=sr_hi,
        sr_lo=sr_lo,
        sc_hi=sc_hi,
        sc_lo=sc_lo,
        bbox=bbox,
        class_id=class_id,
        valid=valid,
    )


@partial(jax.jit, static_argnames=("max_regions",))
def region_counts(seg: jnp.ndarray, img: jnp.ndarray, max_regions: int):
    """Light-weight variant for the throughput path: (area [R+1],
    class_id [R+1]) only — one scalar scatter-add + one scalar scatter-max,
    ~5× less scatter traffic than the full RegionTable.  [B, H, W] inputs
    give [B, R+1] columns."""
    if seg.ndim == 3:
        return jax.vmap(partial(region_counts, max_regions=max_regions))(
            seg, img
        )
    R = max_regions + 1
    ids = seg.ravel()
    area = jax.ops.segment_sum(jnp.ones_like(ids), ids, num_segments=R)
    class_id = jax.ops.segment_max(
        img.ravel().astype(jnp.int32), ids, num_segments=R
    )
    return area, class_id


@jax.jit
def table_lookup(seg: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """``table[seg]`` broadcast of a per-region int table back to pixels.

    ``seg``: [H, W] or [B, H, W] ids; ``table``: [R] or [B, R] (one table per
    plane).  Ids outside [0, R) read 0: a raw gather would clamp past-
    capacity ids to the last row and wrap negative ids.
    """
    R = table.shape[-1]
    table = table.astype(jnp.int32)
    idx = jnp.clip(seg, 0, R - 1)
    if seg.ndim == 3 and table.ndim == 2:
        out = jax.vmap(lambda s, t: t[s])(idx, table)
    else:
        out = table[idx]
    return jnp.where((seg >= 0) & (seg < R), out, 0)


def centroids_int(table: RegionTable) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact truncated centroids ⌊Σrow/area⌋, ⌊Σcol/area⌋ (device int32) —
    the reference's ``int(r.centroid[...])`` lookup coordinates
    (tiff_analysis.py:844,851)."""
    d = jnp.maximum(table.area, 1)
    return (
        _exact_floor_div(table.sr_hi, table.sr_lo, d),
        _exact_floor_div(table.sc_hi, table.sc_lo, d),
    )


def centroids_f64(table) -> Tuple[np.ndarray, np.ndarray]:
    """Exact float64 centroids from a host-fetched table (NumPy arrays)."""
    area = np.maximum(np.asarray(table.area, dtype=np.int64), 1)
    sr = HILO_BASE * np.asarray(table.sr_hi, np.int64) + np.asarray(
        table.sr_lo, np.int64
    )
    sc = HILO_BASE * np.asarray(table.sc_hi, np.int64) + np.asarray(
        table.sc_lo, np.int64
    )
    return sr / area, sc / area
