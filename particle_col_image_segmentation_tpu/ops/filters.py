"""Windowed filters on label planes.

``median_label_filter`` reproduces ``scipy.ndimage.median_filter(x, size=k)``
exactly for small-integer class images (reference call sites:
tiff_analysis.py:122,643 — the 5×5 denoise on Ilastik label maps).

Design: instead of a rank sort, the median of an integer window with
values < K is recovered from cumulative class counts —

    median = #{ v < K-1 : count(window ≤ v) < ceil(n/2) }

which turns the filter into K-1 separable box sums + compares, all fusable
elementwise VPU work with zero data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["median_label_filter", "gaussian_blur"]


def _valid_window_sum(xp: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Windowed sum of an already-padded array: output length is
    input − (size−1) along ``axis``."""
    n = xp.shape[axis] - (size - 1)
    out = None
    for o in range(size):
        sl = [slice(None)] * xp.ndim
        sl[axis] = slice(o, o + n)
        piece = xp[tuple(sl)]
        out = piece if out is None else out + piece
    return out


def _threshold_packing(size: int, num_classes: int):
    """(bits per field, field groups): window counts ≤ size² pack into
    ⌈log2(size²+1)⌉-bit fields, several thresholds per int32 plane — no
    carry between fields, so ONE windowed sum counts them all."""
    bits = max(1, (size * size).bit_length())
    per = max(1, 31 // bits)
    thresholds = list(range(num_classes - 1))
    groups = [thresholds[i : i + per] for i in range(0, len(thresholds), per)]
    return bits, groups


def pack_thresholds(x: jnp.ndarray, group, bits: int) -> jnp.ndarray:
    """One packed indicator plane for a threshold group:
    ``Σ_pos (x ≤ v_pos) << (bits·pos)`` — shared by every median variant
    (reduce_window and the pre-padded valid sums) so the
    packing scheme lives in exactly one place."""
    packed = None
    for pos, v in enumerate(group):
        term = (x <= v).astype(jnp.int32) << (bits * pos)
        packed = term if packed is None else packed + term
    return packed


def median_from_counts(med, counts: jnp.ndarray, group, bits: int,
                       half_rank: int):
    """Fold one group's packed window counts into the median accumulator:
    median = #{v : count(window ≤ v) < half_rank}."""
    fmask = (1 << bits) - 1
    for pos in range(len(group)):
        t = (((counts >> (bits * pos)) & fmask) < half_rank).astype(jnp.int32)
        med = t if med is None else med + t
    return med


def median_label_filter_padded(
    xp: jnp.ndarray, size: int = 5, num_classes: int = 8
) -> jnp.ndarray:
    """Median filter on an input already padded by size//2 on both trailing
    axes (the spatially-sharded path supplies halo rows itself)."""
    x = xp.astype(jnp.int32)
    half_rank = (size * size) // 2 + 1
    bits, groups = _threshold_packing(size, num_classes)
    med = None
    for group in groups:
        packed = pack_thresholds(x, group, bits)
        cum = _valid_window_sum(_valid_window_sum(packed, size, -1), size, -2)
        med = median_from_counts(med, cum, group, bits, half_rank)
    return med.astype(xp.dtype)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_symmetric_aligned(x: jnp.ndarray, half: int) -> jnp.ndarray:
    """Symmetric (scipy 'reflect') padding by ``half`` on the trailing two
    axes, over-padded with zeros to aligned sizes (rows to 8, columns to 128).

    Padding to aligned sizes and writing the four reflected border strips
    in place keeps every consumer on an aligned 2-D layout (a plain
    jnp.pad(..., mode='symmetric') of a 2048² plane is 2052 wide) and is
    bit-identical within the VALID region.
    """
    H, W = x.shape[-2:]
    Hp = _round_up(H + 2 * half, 8)
    Wp = _round_up(W + 2 * half, 128)
    pad = [(0, 0)] * (x.ndim - 2) + [(half, Hp - H - half), (half, Wp - W - half)]
    xp = jnp.pad(x, pad)
    # reflect rows then columns (corner values flow through both writes)
    xp = xp.at[..., :half, :].set(
        jnp.flip(xp[..., half : 2 * half, :], -2)
    )
    xp = xp.at[..., half + H : 2 * half + H, :].set(
        jnp.flip(xp[..., H : half + H, :], -2)
    )
    xp = xp.at[..., :, :half].set(jnp.flip(xp[..., :, half : 2 * half], -1))
    xp = xp.at[..., :, half + W : 2 * half + W].set(
        jnp.flip(xp[..., :, W : half + W], -1)
    )
    return xp


def median_label_filter(img: jnp.ndarray, size: int = 5, num_classes: int = 8):
    """Exact scipy median filter for integer images with values in [0, num_classes).

    Matches scipy.ndimage.median_filter(img, size=size) (mode='reflect') for
    odd ``size`` (the reference uses size=5).  Works on any [..., H, W] batch
    since all work is windowed along the trailing two axes.

    Median of an integer window = #{v : count(window ≤ v) < ⌈n/2⌉},
    with threshold indicators bit-packed into 5-bit fields of int32 planes
    (window counts ≤ size² < 32 — no carry between fields), so 7 thresholds
    ride TWO packed planes through one fused reduce_window instead of seven
    (3.5× less window-sum traffic; see _threshold_packing).
    """
    import jax

    H, W = img.shape[-2:]
    half = size // 2
    half_rank = (size * size) // 2 + 1  # ceil(n/2) for odd n
    bits, groups = _threshold_packing(size, num_classes)
    x = img.astype(jnp.int32)
    xp = _pad_symmetric_aligned(x, half)
    le = jnp.stack([pack_thresholds(xp, group, bits) for group in groups])
    # trailing init-value padding keeps the window output the same aligned
    # size as the input (a VALID output of width Wp−size+1 is misaligned);
    # rows [H:] / cols [W:] are garbage and sliced away.
    counts = jax.lax.reduce_window(
        le,
        jnp.int32(0),
        jax.lax.add,
        window_dimensions=(1,) * (le.ndim - 2) + (size, size),
        window_strides=(1,) * le.ndim,
        padding=((0, 0),) * (le.ndim - 2) + ((0, size - 1), (0, size - 1)),
    )
    med = None
    for g, group in enumerate(groups):
        med = median_from_counts(med, counts[g], group, bits, half_rank)
    return med[..., :H, :W].astype(img.dtype)


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """MATLAB imgaussfilt parity: separable Gaussian, kernel 2·ceil(2σ)+1,
    replicate ('nearest') padding (reference .m:43-62)."""
    import numpy as np

    half = int(np.ceil(2 * sigma))
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)

    x = img.astype(jnp.float32)
    H, W = x.shape[-2:]
    # ONE aligned pad for both axes (see _pad_symmetric_aligned);
    # replicate borders written in place.  Edge
    # replication commutes with the per-axis convolutions, so the result is
    # bit-identical to pad-then-conv per axis (same k-order summation).
    Hp = _round_up(H + 2 * half, 8)
    Wp = _round_up(W + 2 * half, 128)
    pad = [(0, 0)] * (x.ndim - 2) + [
        (half, Hp - H - half), (half, Wp - W - half)
    ]
    xp = jnp.pad(x, pad)
    xp = xp.at[..., :half, :].set(xp[..., half : half + 1, :])
    xp = xp.at[..., half + H :, :].set(xp[..., half + H - 1 : half + H, :])
    xp = xp.at[..., :, :half].set(xp[..., :, half : half + 1])
    xp = xp.at[..., :, half + W :].set(xp[..., :, half + W - 1 : half + W])

    def conv_axis_padded(xp, axis, n):
        out = None
        for o in range(2 * half + 1):
            sl = [slice(None)] * xp.ndim
            sl[axis] = slice(o, o + n)
            piece = xp[tuple(sl)] * k[o]
            out = piece if out is None else out + piece
        return out

    return conv_axis_padded(conv_axis_padded(xp, -2, H), -1, W)
