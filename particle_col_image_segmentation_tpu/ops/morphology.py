"""Binary morphology: disk dilation/erosion, hole filling, local maxima.

Reference call sites: skimage binary_dilation with disk SEs r∈{2,20}
(tiff_analysis.py:828,990), scipy binary_fill_holes (:880), skimage
local_maxima (refine_boundaries.py:62).

Design: disk dilation of any radius is one bounded-EDT threshold (exact —
see ops/edt.py); hole filling and plateau invalidation are boolean fixpoints
solved with the same neighbor-step + row/column segmented-scan machinery as
CCL, so they converge in O(#bends) iterations, not O(path length).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.edt import edt_sq
from particle_col_image_segmentation_tpu.ops.scans import seg_or_scan_bidi

__all__ = [
    "dilate_disk",
    "erode_disk",
    "open_disk",
    "close_disk",
    "fill_holes",
    "local_maxima",
    "boundary_mask",
]


def dilate_disk(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """binary_dilation(mask, disk(radius)) — exact via EDT(¬mask) ≤ r."""
    return edt_sq(mask, cap=radius) <= radius * radius


def erode_disk(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """binary_erosion with disk(radius), True border (skimage semantics)."""
    return ~dilate_disk(~mask.astype(bool), radius)


def open_disk(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """binary_opening (erode then dilate) with disk(radius) — removes
    features thinner than the disk (BASELINE config #3 morphology)."""
    return dilate_disk(erode_disk(mask, radius), radius)


def close_disk(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """binary_closing (dilate then erode) with disk(radius) — fills gaps
    narrower than the disk."""
    return erode_disk(dilate_disk(mask, radius), radius)


def _neighbor_or(x: jnp.ndarray, allowed: jnp.ndarray, connectivity: int = 4):
    """One propagation step of x through ``allowed`` pixels."""
    H, W = x.shape[-2:]
    offsets4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    offsets8 = offsets4 + [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    out = x
    for dy, dx in offsets8 if connectivity == 8 else offsets4:
        sl_src = (
            Ellipsis,
            slice(max(0, -dy), H - max(0, dy)),
            slice(max(0, -dx), W - max(0, dx)),
        )
        sl_dst = (
            Ellipsis,
            slice(max(0, dy), H - max(0, -dy)),
            slice(max(0, dx), W - max(0, -dx)),
        )
        shifted = jnp.zeros_like(x).at[sl_dst].set(x[sl_src])
        out = out | shifted
    return out & allowed


def _propagate_fixpoint(seed, allowed, same_row, same_col, connectivity, max_iters):
    """OR-propagate ``seed`` through ``allowed``, scan-accelerated fixpoint.
    Returns (out, converged) — False means ``max_iters`` ran out with
    propagation still spreading (the result is NOT the fixpoint)."""

    def body(state):
        x, _, i = state
        new = _neighbor_or(x, allowed, connectivity)
        new = seg_or_scan_bidi(new, same_row, axis=-1) & allowed
        new = seg_or_scan_bidi(new, same_col, axis=-2) & allowed
        return new, jnp.any(new != x), i + 1

    def cond(state):
        _, changed, i = state
        return changed & (i < max_iters)

    out, changed, _ = jax.lax.while_loop(
        cond, body, (seed & allowed, jnp.bool_(True), 0)
    )
    return out, ~changed


def _run_masks(allowed):
    """same_prev connectivity masks for runs of ``allowed`` along rows/cols."""
    W = allowed.shape[-1]
    same_row = jnp.concatenate(
        [
            jnp.zeros(allowed.shape[:-1] + (1,), bool),
            allowed[..., :, 1:] & allowed[..., :, :-1],
        ],
        axis=-1,
    )
    same_col = jnp.concatenate(
        [
            jnp.zeros(allowed.shape[:-2] + (1, W), bool),
            allowed[..., 1:, :] & allowed[..., :-1, :],
        ],
        axis=-2,
    )
    return same_row, same_col


@partial(jax.jit, static_argnames=("max_iters", "with_flag"))
def fill_holes(
    mask: jnp.ndarray, max_iters: int = 256, with_flag: bool = False
) -> jnp.ndarray:
    """scipy.ndimage.binary_fill_holes parity (4-connected background flood).

    Background connected to the border stays background; every other
    background pixel is a hole and gets filled.  ``with_flag=True`` appends
    a ``converged`` bool — False means the flood budget ran out and
    unreached corridors were WRONGLY filled; callers must surface it.
    """
    mask = mask.astype(bool)
    bg = ~mask
    H, W = mask.shape[-2:]
    border = jnp.zeros(mask.shape, bool)
    border = border.at[..., 0, :].set(True)
    border = border.at[..., -1, :].set(True)
    border = border.at[..., :, 0].set(True)
    border = border.at[..., :, -1].set(True)
    same_row, same_col = _run_masks(bg)
    reach, conv = _propagate_fixpoint(
        border & bg, bg, same_row, same_col, 4, max_iters
    )
    return (~reach, conv) if with_flag else ~reach


@partial(jax.jit, static_argnames=("connectivity", "max_iters", "with_flag"))
def local_maxima(
    img: jnp.ndarray, connectivity: int = 2, max_iters: int = 256,
    with_flag: bool = False,
) -> jnp.ndarray:
    """skimage.morphology.local_maxima parity (plateau-aware, borders allowed).

    A pixel is marked iff its equal-value plateau has no neighbor with a
    strictly greater value.  "Bad" status (has higher neighbor) is flood-
    propagated through equal-valued runs to the whole plateau.
    ``with_flag=True`` appends a ``converged`` bool (False ⇔ the plateau
    flood budget ran out — spurious maxima may remain).
    """
    H, W = img.shape[-2:]
    offsets4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    offsets8 = offsets4 + [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    offsets = offsets8 if connectivity == 2 else offsets4

    def _slices(dy, dx):
        sl_src = (
            Ellipsis,
            slice(max(0, -dy), H - max(0, dy)),
            slice(max(0, -dx), W - max(0, dx)),
        )
        sl_dst = (
            Ellipsis,
            slice(max(0, dy), H - max(0, -dy)),
            slice(max(0, dx), W - max(0, -dx)),
        )
        return sl_src, sl_dst

    # has_higher and the per-offset plateau-equality masks are computed ONCE
    # (value comparisons are loop invariant; recomputing the 8 full-plane
    # masks inside the flood body was ~20 ms/iteration of pure re-read
    # traffic at [8,512,512] f32).  Comparisons run on the overlap windows
    # directly — no -inf-padded full-plane neighbor materialization, so any
    # input dtype works unchanged.
    has_higher = jnp.zeros(img.shape, bool)
    eq_masks = []
    for dy, dx in offsets:
        sl_src, sl_dst = _slices(dy, dx)
        src, dst = img[sl_src], img[sl_dst]
        has_higher = has_higher.at[sl_dst].set(has_higher[sl_dst] | (src > dst))
        eq = jnp.zeros(img.shape, bool).at[sl_dst].set(src == dst)
        eq_masks.append(eq)

    # Propagate "bad" through equal-value plateaus (8-conn within plateau).
    same_row = jnp.concatenate(
        [
            jnp.zeros(img.shape[:-1] + (1,), bool),
            img[..., :, 1:] == img[..., :, :-1],
        ],
        axis=-1,
    )
    same_col = jnp.concatenate(
        [
            jnp.zeros(img.shape[:-2] + (1, W), bool),
            img[..., 1:, :] == img[..., :-1, :],
        ],
        axis=-2,
    )

    def body(state):
        bad, _, i = state
        new = bad
        for (dy, dx), eq in zip(offsets, eq_masks):
            sl_src, sl_dst = _slices(dy, dx)
            shifted_bad = jnp.zeros_like(bad).at[sl_dst].set(bad[sl_src])
            new = new | (shifted_bad & eq)
        new = new | seg_or_scan_bidi(new, same_row, axis=-1)
        new = new | seg_or_scan_bidi(new, same_col, axis=-2)
        # per-plane change tracking so batched callers can name the plane
        # whose plateau-flood budget ran out
        return new, jnp.any(new != bad, axis=(-2, -1)), i + 1

    def cond(state):
        _, changed, i = state
        return jnp.any(changed) & (i < max_iters)

    bad, changed, _ = jax.lax.while_loop(
        cond, body, (has_higher, jnp.ones(img.shape[:-2], bool), 0)
    )
    return (~bad, ~changed) if with_flag else ~bad


def boundary_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """Mask pixels with a 4-neighbor outside the mask (or on the image edge) —
    the bwboundaries pixel set (reference .m:291-292)."""
    m = mask.astype(bool)
    H, W = m.shape[-2:]
    interior = m
    for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        sl_src = (
            Ellipsis,
            slice(max(0, -dy), H - max(0, dy)),
            slice(max(0, -dx), W - max(0, dx)),
        )
        sl_dst = (
            Ellipsis,
            slice(max(0, dy), H - max(0, -dy)),
            slice(max(0, dx), W - max(0, -dx)),
        )
        shifted = jnp.zeros(m.shape, bool).at[sl_dst].set(m[sl_src])
        interior = interior & shifted
    return m & ~interior
