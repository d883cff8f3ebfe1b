"""Intensity thresholding on device (BASELINE config #1: Otsu + CCL count).

The reference consumes pre-classified Ilastik label maps, so it never
thresholds raw intensities itself — but the framework's raw-TIFF entry path
(BASELINE.json config #1: "Otsu threshold + connected-components particle
count" on 16-bit planes) needs one.  Classic Otsu on a device-computed
histogram: all per-bin statistics are vectorized prefix sums, no
data-dependent control flow.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "histogram",
    "otsu_threshold",
    "otsu_threshold_batch",
    "threshold_and_count",
    "threshold_and_count_batch",
]


@partial(jax.jit, static_argnames=("bins",))
def histogram(img: jnp.ndarray, bins: int = 256) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(counts [bins], bin centers [bins]) over the image's [min, max] range —
    skimage.filters.threshold_otsu binning semantics."""
    x = img.astype(jnp.float32)
    lo = jnp.min(x)
    hi = jnp.max(x)
    span = jnp.maximum(hi - lo, 1e-12)
    idx = jnp.clip(((x - lo) / span * bins).astype(jnp.int32), 0, bins - 1)
    counts = jnp.zeros((bins,), jnp.int32).at[idx.ravel()].add(1)
    centers = lo + (jnp.arange(bins, dtype=jnp.float32) + 0.5) * span / bins
    return counts, centers


@partial(jax.jit, static_argnames=("bins",))
def otsu_threshold(img: jnp.ndarray, bins: int = 256) -> jnp.ndarray:
    """Otsu's threshold: the bin-center cut maximizing between-class variance
    σ²_b(t) = ω₀ω₁(μ₀ − μ₁)².  Pixels > threshold are foreground."""
    counts, centers = histogram(img, bins)
    c = counts.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    w0 = jnp.cumsum(c)
    w1 = w0[-1] - w0
    m = jnp.cumsum(c * centers)
    mu0 = m / jnp.maximum(w0, 1e-12)
    mu1 = (m[-1] - m) / jnp.maximum(w1, 1e-12)
    var_b = w0 * w1 * (mu0 - mu1) ** 2
    # cuts with an empty class score 0 and never win on non-constant images
    var_b = jnp.where((w0 > 0) & (w1 > 0), var_b, -1.0)
    return centers[jnp.argmax(var_b)]


def _histogram_batch(x3: jnp.ndarray, bins: int):
    """Per-plane histograms of [B, H, W] over each plane's [min, max] range
    (skimage.threshold_otsu binning — same idx/edges as ``histogram``)."""
    lo = jnp.min(x3, axis=(-2, -1), keepdims=True)
    hi = jnp.max(x3, axis=(-2, -1), keepdims=True)
    span = jnp.maximum(hi - lo, 1e-12)
    idx = jnp.clip(((x3 - lo) / span * bins).astype(jnp.int32), 0, bins - 1)
    counts = jax.vmap(
        lambda i: jnp.zeros((bins,), jnp.int32).at[i.ravel()].add(1)
    )(idx)
    centers = (
        lo[..., 0]
        + (jnp.arange(bins, dtype=jnp.float32) + 0.5) * span[..., 0] / bins
    )
    return counts, centers


def _otsu_from_hist(counts: jnp.ndarray, centers: jnp.ndarray) -> jnp.ndarray:
    """Vectorized Otsu reduction over [..., bins] histograms — the same
    math (and dtype policy) as ``otsu_threshold``, batched along leading
    axes; thresholds are bit-identical to the per-plane call."""
    c = counts.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    w0 = jnp.cumsum(c, axis=-1)
    w1 = w0[..., -1:] - w0
    m = jnp.cumsum(c * centers, axis=-1)
    mu0 = m / jnp.maximum(w0, 1e-12)
    mu1 = (m[..., -1:] - m) / jnp.maximum(w1, 1e-12)
    var_b = w0 * w1 * (mu0 - mu1) ** 2
    var_b = jnp.where((w0 > 0) & (w1 > 0), var_b, -1.0)
    best = jnp.argmax(var_b, axis=-1)
    return jnp.take_along_axis(centers, best[..., None], axis=-1)[..., 0]


@partial(jax.jit, static_argnames=("bins",))
def otsu_threshold_batch(imgs: jnp.ndarray, bins: int = 256) -> jnp.ndarray:
    """Per-plane Otsu thresholds for a [B, H, W] stack; bit-identical to
    ``otsu_threshold`` on each plane."""
    counts, centers = _histogram_batch(imgs.astype(jnp.float32), bins)
    return _otsu_from_hist(counts, centers)


@partial(jax.jit, static_argnames=("max_regions", "min_area"))
def threshold_and_count(
    img: jnp.ndarray, max_regions: int = 4096, min_area: int = 1
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """BASELINE config #1 as one fused graph: Otsu → binary mask → CCL →
    particle count.  Returns (mask, compact labels, count of components with
    area ≥ min_area, num_components).

    ``num_components`` is the TRUE component count: callers must check it
    against ``max_regions`` — components past capacity are dropped from the
    area table, so ``count`` undercounts when num_components > max_regions
    (same overflow contract as run_batch's PlaneStats)."""
    from particle_col_image_segmentation_tpu.ops.ccl import (
        compact_labels,
        connected_components,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops import region_counts

    t = otsu_threshold_batch(img[None])[0]
    mask = img.astype(jnp.float32) > t
    raw = connected_components(mask.astype(jnp.uint8), background=0, num_classes=2)
    seg, num = compact_labels(raw, max_regions)
    area, _ = region_counts(seg, mask.astype(jnp.int32), max_regions)
    count = jnp.sum((area[1:] >= min_area).astype(jnp.int32))
    return mask, seg, count, num


@partial(jax.jit, static_argnames=("max_regions", "min_area"))
def threshold_and_count_batch(
    imgs: jnp.ndarray, max_regions: int = 4096, min_area: int = 1
):
    """Batched config #1: per-plane Otsu → CCL → per-plane particle counts,
    one launch for a whole [B, H, W] stack (every stage batches over the
    leading axis).

    Background pixels are labeled too (``background=None`` keeps the CCL on
    the cheap uint8 value path); the count filters to foreground (class 1)
    regions with area ≥ ``min_area``.  Returns (mask [B,H,W], seg [B,H,W],
    count [B], num_fg [B], num_total [B], converged [B]).

    Overflow contract: ``num_total`` is the TRUE per-plane component count
    (foreground + background, from compaction — NOT capacity-clamped);
    callers must treat ``count``/``num_fg`` of planes with
    num_total > max_regions as undercounts, because components past
    capacity are dropped from the region table (``num_fg`` alone cannot
    detect this — it is summed over the table and never exceeds
    max_regions).
    """
    from particle_col_image_segmentation_tpu.ops.ccl import (
        compact_labels,
        connected_components,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops import region_counts

    x = imgs.astype(jnp.float32)
    t = otsu_threshold_batch(x)  # [B]
    mask = x > t[:, None, None]
    m8 = mask.astype(jnp.uint8)
    raw, converged = connected_components(
        m8, background=None, num_classes=2, with_flag=True
    )
    seg, num_total = compact_labels(raw, max_regions)
    areas, classes = region_counts(seg, m8, max_regions)
    fg = (classes == 1) & (areas > 0)
    count = jnp.sum((fg & (areas >= min_area)).astype(jnp.int32), axis=-1)
    num_fg = jnp.sum(fg.astype(jnp.int32), axis=-1)
    return mask, seg, count, num_fg, num_total, converged
