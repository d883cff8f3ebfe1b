"""Blocked pairwise-distance reductions (MATLAB pdist2 + min parity).

Reference call sites: .m:259-268 (nearest neighbor between ROI classes) and
:301-304 (ROI → aggregate-boundary distance).  Distances are computed as
direct coordinate differences (Σ(aᵢ−bᵢ)²), blocked over the second set with
a running min so the full distance matrix is never materialized.

Deliberately NOT the ‖a‖²+‖b‖²−2abᵀ matmul expansion: accelerators' default
matmul precision may truncate f32 operands (TF32 on a GPU keeps 10 mantissa
bits, and centroids like 2001.1 are not representable), and even at full
f32 the expansion cancels
catastrophically for nearby points with large coordinates (terms ~|a||b|
round at ~0.5 px² for 2k-px planes, swamping a 1 px distance).  The
difference form subtracts first, so small distances stay exact — matching
MATLAB's double-precision pdist2 to f32 on the coordinates themselves.
The O(N·M·2) VPU work is negligible at centroid-set sizes (≤ tens of
thousands of points).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["min_dist_to_set", "nearest_neighbor_dists"]


@partial(jax.jit, static_argnames=("block",))
def min_dist_to_set(
    a: jnp.ndarray,
    b: jnp.ndarray,
    b_valid: jnp.ndarray,
    block: int = 1024,
) -> jnp.ndarray:
    """For each row of ``a`` [N,2], the min Euclidean distance to any valid
    row of ``b`` [M,2].  Invalid b rows are ignored; all-invalid → +inf."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    M = b.shape[0]
    pad = (-M) % block
    b = jnp.pad(b, ((0, pad), (0, 0)))
    bv = jnp.pad(b_valid.astype(bool), (0, pad))
    nb = b.shape[0] // block
    b_blocks = b.reshape(nb, block, 2)
    v_blocks = bv.reshape(nb, block)

    def step(carry, xs):
        bb, vb = xs
        diff = a[:, None, :] - bb[None, :, :]  # [N, block, 2]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(vb[None, :], d2, jnp.inf)
        return jnp.minimum(carry, jnp.min(d2, axis=1)), None

    init = jnp.full((a.shape[0],), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(step, init, (b_blocks, v_blocks))
    return jnp.sqrt(jnp.maximum(out, 0.0))


@partial(jax.jit, static_argnames=("block",))
def nearest_neighbor_dists(
    pts: jnp.ndarray, valid: jnp.ndarray, block: int = 1024
) -> jnp.ndarray:
    """Within-set nearest-neighbor distance per point (self excluded)."""
    pts = pts.astype(jnp.float32)
    N = pts.shape[0]
    pad = (-N) % block
    b = jnp.pad(pts, ((0, pad), (0, 0)))
    bv = jnp.pad(valid.astype(bool), (0, pad))
    nb = b.shape[0] // block
    b_blocks = b.reshape(nb, block, 2)
    v_blocks = bv.reshape(nb, block)
    idx_blocks = jnp.arange(nb * block).reshape(nb, block)
    own = jnp.arange(N)

    def step(carry, xs):
        bb, vb, ib = xs
        diff = pts[:, None, :] - bb[None, :, :]  # [N, block, 2]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(vb[None, :] & (ib[None, :] != own[:, None]), d2, jnp.inf)
        return jnp.minimum(carry, jnp.min(d2, axis=1)), None

    init = jnp.full((N,), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(step, init, (b_blocks, v_blocks, idx_blocks))
    return jnp.sqrt(jnp.maximum(out, 0.0))
