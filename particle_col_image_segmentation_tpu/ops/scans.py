"""Segmented associative scans — the workhorse of the iterative kernels.

Vector-friendly building blocks: log-depth ``jax.lax.associative_scan`` over
(value, segment-boundary) pairs propagates min/or within runs of equal-valued
pixels along rows or columns.  CCL, flood fill, and vertical EDT all reduce to
these, avoiding sequential per-pixel loops that XLA cannot vectorize.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "seg_min_scan",
    "seg_min_scan_bidi",
    "seg_or_scan_bidi",
    "directional_distance",
]


def _seg_min_combine(a, b):
    m1, b1 = a
    m2, b2 = b
    return jnp.where(b2, m2, jnp.minimum(m1, m2)), b1 | b2


def seg_min_scan(vals: jnp.ndarray, boundary: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Running min within segments along ``axis``.

    ``boundary[..., i]`` True means element i starts a new segment (is not
    connected to element i-1 along the axis).
    """
    out, _ = jax.lax.associative_scan(_seg_min_combine, (vals, boundary), axis=axis)
    return out


def seg_min_scan_bidi(vals, same_prev, axis):
    """Min over each element's whole segment (forward + backward scans).

    ``same_prev[..., i]`` True when element i is connected to element i-1
    along ``axis`` (first element must be False).
    """
    fwd = seg_min_scan(vals, ~same_prev, axis)
    rev = jnp.flip(
        seg_min_scan(jnp.flip(vals, axis), ~_flip_same(same_prev, axis), axis), axis
    )
    return jnp.minimum(fwd, rev)


def _flip_same(same_prev, axis):
    """same_prev of the flipped array: element i connected to i-1 after flip
    ⇔ original element n-i connected to n-i+1 ⇔ same_prev shifted."""
    # connected_flipped[j] ⇔ connected(orig n-1-j, orig n-j) = same_prev[n-j]
    # = flip(same_prev)[j-1], i.e. flip then shift by one.
    flipped = jnp.flip(same_prev, axis)
    rolled = jnp.roll(flipped, 1, axis)
    # first element of the flipped order has no previous ⇒ new segment
    idx = [slice(None)] * same_prev.ndim
    idx[axis] = 0
    rolled = rolled.at[tuple(idx)].set(False)
    return rolled


def _seg_or_combine(a, b):
    v1, b1 = a
    v2, b2 = b
    return jnp.where(b2, v2, v1 | v2), b1 | b2


def seg_or_scan_bidi(vals, same_prev, axis):
    """OR over each element's whole segment (forward + backward)."""
    fwd, _ = jax.lax.associative_scan(_seg_or_combine, (vals, ~same_prev), axis=axis)
    rv = jnp.flip(vals, axis)
    rb = ~_flip_same(same_prev, axis)
    rev, _ = jax.lax.associative_scan(_seg_or_combine, (rv, rb), axis=axis)
    return fwd | jnp.flip(rev, axis)


def _dist_combine(a, b):
    d1, n1 = a
    d2, n2 = b
    return jnp.minimum(d2, d1 + n2), n1 + n2


def directional_distance(feature: jnp.ndarray, axis: int, cap: int) -> jnp.ndarray:
    """Distance (element count) to the nearest feature pixel at or before each
    position along ``axis``, capped.  0 on feature pixels.

    Log-depth associative scan over (distance-from-span-end, span-length).
    """
    d0 = jnp.where(feature, 0, cap).astype(jnp.int32)
    n0 = jnp.ones_like(d0)
    d, _ = jax.lax.associative_scan(_dist_combine, (d0, n0), axis=axis)
    return jnp.minimum(d, cap)
