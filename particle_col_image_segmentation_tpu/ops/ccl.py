"""Connected-component labeling as an XLA fixpoint.

Replaces the reference's skimage union-find CCL (call sites:
tiff_analysis.py:744, 829, 260; refine_boundaries.py:63) with an iterative
min-label propagation that XLA compiles to pure vector work:

  label₀ = linear pixel index
  repeat until fixpoint:
    1. 8-neighbor masked min        (bridges diagonals, one hop)
    2. row + column segmented scans (log-depth, propagates along runs)
    3. pointer jumping  lab ← min(lab, lab[lab])  (collapses long chains)

The min over same-valued neighbors is a semilattice update, so the fixpoint is
iteration-order independent (determinism by construction; SURVEY.md §5).
At convergence every pixel holds the minimum linear index of its component —
compacting those roots in ascending order reproduces skimage's raster-order
label ids exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.scans import seg_min_scan_bidi

__all__ = ["connected_components", "compact_labels", "label_image"]

_INF = jnp.iinfo(jnp.int32).max


def _window_min_same(x, connectivity: int):
    """3×3 (or cross) windowed min via fused reduce_window; SAME padding
    supplies the +INF boundary directly (no pre-pad, layouts stay aligned)."""
    n = x.ndim
    if connectivity == 8:
        return jax.lax.reduce_window(
            x,
            jnp.int32(_INF),
            jax.lax.min,
            window_dimensions=(1,) * (n - 2) + (3, 3),
            window_strides=(1,) * n,
            padding="SAME",
        )
    xr = jax.lax.reduce_window(
        x, jnp.int32(_INF), jax.lax.min,
        window_dimensions=(1,) * (n - 2) + (1, 3),
        window_strides=(1,) * n, padding="SAME",
    )
    xc = jax.lax.reduce_window(
        x, jnp.int32(_INF), jax.lax.min,
        window_dimensions=(1,) * (n - 2) + (3, 1),
        window_strides=(1,) * n, padding="SAME",
    )
    return jnp.minimum(xr, xc)


def _neighbor_min(lab, img, connectivity: int, num_classes: int):
    """Min label over same-valued neighbors (and self).

    Class-decomposed with all classes stacked on one leading axis, so a
    single fused windowed min covers every class (stacking is nearly free;
    per-class separate reduce_windows are ~num_classes× slower).  Pixels
    whose value is outside [0, num_classes) — the uniquified background
    sentinels — take no neighbors and keep their own label.
    """
    stacked = jnp.stack(
        [jnp.where(img == v, lab, _INF) for v in range(num_classes)]
    )
    mins = _window_min_same(stacked, connectivity)
    out = lab
    for v in range(num_classes):
        out = jnp.where(img == v, jnp.minimum(out, mins[v]), out)
    return out


def _pointer_jump(lab):
    flat = lab.reshape(lab.shape[:-2] + (-1,))
    idx = jnp.clip(flat, 0, flat.shape[-1] - 1)
    jumped = jnp.take_along_axis(flat, idx, axis=-1)
    return jnp.minimum(flat, jumped).reshape(lab.shape)


@partial(
    jax.jit,
    static_argnames=("connectivity", "max_iters", "num_classes", "with_flag"),
)
def connected_components(
    img: jnp.ndarray,
    background: Optional[jnp.ndarray] = None,
    connectivity: int = 8,
    max_iters: int = 64,
    num_classes: int = 8,
    with_flag: bool = False,
) -> jnp.ndarray:
    """Label components of equal-valued pixels.

    Args:
      img: [..., H, W] integer class image with values in [0, num_classes).
      background: optional scalar — pixels with this value get label -1
        (skimage background=0 semantics). None labels every pixel.
      connectivity: 8 (skimage 2D default) or 4.
      max_iters: safety bound on the fixpoint loop.
      num_classes: exclusive upper bound on pixel values (static; drives the
        class-decomposed neighbor-min).
      with_flag: also return a per-plane bool ``converged`` ([...] batch
        shape) — False means ``max_iters`` ran out with labels still
        changing; the labels are then NOT a valid CCL and callers must
        surface the failure rather than use them.

    Returns:
      [..., H, W] int32; each foreground pixel holds the minimum linear index
      (row-major, per plane) of its component; background pixels hold -1.
    """
    H, W = img.shape[-2:]
    img = img.astype(jnp.int32)
    lin = (
        jax.lax.broadcasted_iota(jnp.int32, img.shape, img.ndim - 2) * W
        + jax.lax.broadcasted_iota(jnp.int32, img.shape, img.ndim - 1)
    )
    if background is not None:
        fg = img != background
        # unique negative value per background pixel prevents bg-bg merging
        img = jnp.where(fg, img, -2 - lin)
    else:
        fg = jnp.ones(img.shape, bool)

    same_row = jnp.concatenate(
        [jnp.zeros(img.shape[:-1] + (1,), bool), img[..., :, 1:] == img[..., :, :-1]],
        axis=-1,
    )
    same_col = jnp.concatenate(
        [jnp.zeros(img.shape[:-2] + (1, W), bool), img[..., 1:, :] == img[..., :-1, :]],
        axis=-2,
    )

    batch_shape = img.shape[:-2]

    def body(state):
        lab, _, i = state
        new = _neighbor_min(lab, img, connectivity, num_classes)
        new = seg_min_scan_bidi(new, same_row, axis=-1)
        new = seg_min_scan_bidi(new, same_col, axis=-2)
        # Pointer jumping is only an accelerator — at the neighbor-min
        # fixpoint labels are already component-constant (min-update between
        # every neighbor pair forces equality), and the update is confluent,
        # so jumping every round reaches the same fixpoint.
        new = _pointer_jump(new)
        changed = jnp.any(new != lab, axis=(-2, -1))  # per plane
        return new, changed, i + 1

    def cond(state):
        _, changed, i = state
        return jnp.any(changed) & (i < max_iters)

    lab0 = lin
    lab, changed, _ = jax.lax.while_loop(
        cond, body, (lab0, jnp.ones(batch_shape, bool), 0)
    )
    out = jnp.where(fg, lab, -1)
    if with_flag:
        return out, ~changed
    return out


@partial(jax.jit, static_argnames=("max_regions",))
def compact_labels(
    raw: jnp.ndarray, max_regions: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compact root labels to skimage-style ids — sort-free.

    Every component's label is the linear index of its root (first) pixel, so
    the compact id of a component is simply the number of roots at or before
    its root position: one prefix-sum over the root-indicator plane plus one
    gather, instead of a 4M-element sort-unique.

    Args:
      raw: [..., H, W] output of connected_components; leading axes are
        independent planes.
      max_regions: static capacity hint (kept in the signature so callers pin
        table sizes; ``num`` is always the true count — callers must check it
        against their capacity).

    Returns:
      seg: [..., H, W] int32 ids — 0 for background (-1), 1..N in raster
        order of each component's first pixel (skimage ordering).
      num: [...] true number of components per plane (may exceed
        max_regions).
    """
    del max_regions  # shape-independent now; kept for API stability
    H, W = raw.shape[-2:]
    flat = raw.reshape(raw.shape[:-2] + (H * W,))
    lin = jnp.arange(H * W, dtype=jnp.int32)
    fg = flat >= 0
    is_root = (flat == lin) & fg
    # rank of each root, 1-based
    prefix = jnp.cumsum(is_root.astype(jnp.int32), axis=-1)
    num = prefix[..., -1]
    idx = jnp.clip(flat, 0, H * W - 1)
    seg = jnp.where(fg, jnp.take_along_axis(prefix, idx, axis=-1), 0)
    return seg.reshape(raw.shape), num


def label_image(
    img: jnp.ndarray,
    background: Optional[int] = None,
    connectivity: int = 8,
    max_regions: int = 16384,
    num_classes: int = 8,
):
    """skimage.measure.label parity: (ids [H,W], num_components)."""
    raw = connected_components(
        img, background=background, connectivity=connectivity, num_classes=num_classes
    )
    return compact_labels(raw, max_regions)
