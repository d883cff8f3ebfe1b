"""Halo exchange along the spatial mesh axis (inside shard_map).

Each shard holds a contiguous band of plane rows; iterative kernels (median
window, CCL neighbor steps) need ``halo`` rows from each neighbor every
step.  Implemented with ``jax.lax.ppermute`` shifts between neighboring devices; global plane
edges receive a fill value (or symmetric reflection for filter padding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.parallel.mesh import SPACE_AXIS

__all__ = ["exchange_rows", "pad_with_halo"]


def exchange_rows(x: jnp.ndarray, halo: int, axis_name: str = SPACE_AXIS):
    """Fetch ``halo`` boundary rows from the up/down neighbors of this shard.

    Supports halos larger than the shard height via multi-hop ppermute (the
    bounded-EDT cap can exceed a fine mesh's band height).

    Args:
      x: [..., h_local, W] local band.
    Returns:
      (top, bottom): the ``halo`` rows directly above / below this shard's
      band; zeros where the plane has no such rows (global edges).
    """
    n = jax.lax.axis_size(axis_name)
    h_loc = x.shape[-2]
    if halo == 0:  # zero hops would leave the part lists empty (IndexError)
        empty = x[..., :0, :]
        return empty, empty
    hops = -(-halo // h_loc)  # ceil

    # Ship only the rows each hop actually contributes (the far hop carries
    # the remainder): ppermuting the full band per hop would move h_loc/halo×
    # the needed bytes between devices inside the hottest fixpoint loops.  Hop k<hops
    # contributes a full band (r_k = h_loc); hop k=hops the remaining rows —
    # the parts concatenate to exactly ``halo`` contiguous rows.
    top_parts = []
    bottom_parts = []
    for k in range(1, hops + 1):
        r_k = min(h_loc, halo - (k - 1) * h_loc)
        down_perm = [(i, i + k) for i in range(n - k)]
        up_perm = [(i + k, i) for i in range(n - k)]
        # shard i∓k's boundary rows (zeros when that shard doesn't exist)
        top_parts.insert(
            0, jax.lax.ppermute(x[..., h_loc - r_k :, :], axis_name, down_perm)
        )
        bottom_parts.append(
            jax.lax.ppermute(x[..., :r_k, :], axis_name, up_perm)
        )
    top = jnp.concatenate(top_parts, axis=-2) if hops > 1 else top_parts[0]
    bottom = (
        jnp.concatenate(bottom_parts, axis=-2) if hops > 1 else bottom_parts[0]
    )
    return top, bottom


def pad_with_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str = SPACE_AXIS,
    edge_mode: str = "symmetric",
    fill=0,
):
    """[..., h, W] → [..., h+2·halo, W]: neighbor rows where available,
    ``edge_mode`` ('symmetric' reflection or 'constant' fill) at the global
    plane edges.  'constant' supports halos larger than the band height
    (multi-hop exchange); 'symmetric' requires halo ≤ h (its only user is
    the small median window)."""
    if edge_mode not in ("symmetric", "constant"):
        # silently zero-filling for a typo'd numpy-style mode ("reflect",
        # "mirror") would corrupt edge rows with no error
        raise ValueError(f"edge_mode must be 'symmetric' or 'constant', got {edge_mode!r}")
    if halo == 0:
        return x
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    h_loc = x.shape[-2]
    top, bottom = exchange_rows(x, halo, axis_name)
    if edge_mode == "symmetric":
        assert halo <= h_loc, (halo, h_loc)
        edge_top = jnp.flip(x[..., :halo, :], axis=-2)
        edge_bottom = jnp.flip(x[..., -halo:, :], axis=-2)
        top = jnp.where((idx == 0), edge_top, top)
        bottom = jnp.where((idx == n - 1), edge_bottom, bottom)
    else:
        # per-row validity: the r-th top halo row is global row
        # idx·h − halo + r; rows outside [0, n·h) take the fill value.
        r = jax.lax.broadcasted_iota(jnp.int32, top.shape[-2:], 0)
        shape = (1,) * (x.ndim - 2) + top.shape[-2:]
        r = r.reshape(shape)
        top_global = idx * h_loc - halo + r
        top = jnp.where(top_global < 0, jnp.asarray(fill, top.dtype), top)
        bot_global = (idx + 1) * h_loc + r
        bottom = jnp.where(
            bot_global >= n * h_loc, jnp.asarray(fill, bottom.dtype), bottom
        )
    return jnp.concatenate([top, x, bottom], axis=-2)
