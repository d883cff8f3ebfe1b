"""Prefetching batch loader: host decode overlapped with device compute.

Host-side pipeline parallelism (SURVEY.md §2.8): a thread pool decodes
TIFF/HDF5 planes ahead of the device while the current batch computes, and
batches are shipped with ``jax.device_put`` ahead of use.  This replaces the
reference's synchronous per-file loop (tiff_analysis.py:107-153).
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np

from particle_col_image_segmentation_tpu.utils.logging import get_logger

_log = get_logger("loader")


def prefetch_map_paths(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    num_workers: int = 4,
    prefetch: int = 8,
    on_error: str = "raise",
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(path, load_fn(path))`` in order with ``prefetch`` in flight.

    ``on_error="skip"`` logs a failing decode and continues with the next
    path instead of killing the stream — one corrupt file in a 100k-plane
    overnight batch must not drop the remaining work (the un-yielded path
    stays unmarked in any manifest, so a resume after fixing the file
    retries it).  The default ``"raise"`` re-raises, after cancelling the
    queued loads so the exception surfaces without draining the pipeline.
    """
    assert on_error in ("raise", "skip"), on_error
    pool = cf.ThreadPoolExecutor(num_workers)
    try:
        futures: deque = deque()
        it = iter(paths)

        def submit() -> None:
            try:
                p = next(it)
            except StopIteration:
                return
            futures.append((p, pool.submit(load_fn, p)))

        for _ in range(prefetch):
            submit()
        while futures:
            path, done = futures.popleft()
            submit()
            try:
                plane = done.result()
            except Exception:
                if on_error == "skip":
                    _log.exception("skipping %s: decode failed", path)
                    continue
                raise
            yield path, plane
    finally:
        # On exception or early consumer exit, drop queued decodes and do
        # not block on in-flight ones — the error/exit should surface now,
        # not after 2·batch_size decodes drain
        pool.shutdown(wait=False, cancel_futures=True)


def prefetch_map(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    num_workers: int = 4,
    prefetch: int = 8,
    on_error: str = "raise",
) -> Iterator[np.ndarray]:
    """Yield ``load_fn(path)`` in order with ``prefetch`` loads in flight."""
    for _, plane in prefetch_map_paths(
        load_fn, paths, num_workers=num_workers, prefetch=prefetch,
        on_error=on_error,
    ):
        yield plane


def pack_nibbles(arr: np.ndarray) -> np.ndarray:
    """Host-side 4-bit packing of a label batch [..., W] (values in [0, 16),
    W even) → [..., W/2] uint8: halves the host→device transfer.

    Raises ValueError on out-of-range values — a stray 0/255 mask would
    otherwise corrupt BOTH pixels of each packed pair silently."""
    if arr.shape[-1] % 2 != 0:
        raise ValueError(f"pack_nibbles needs an even width, got {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() > 15):
        raise ValueError(
            "pack_nibbles: values outside [0, 15] "
            f"(got min={arr.min()}, max={arr.max()}) — 4-bit packing would "
            "corrupt both pixels of the pair; ship this batch unpacked"
        )
    a = arr.astype(np.uint8)
    return (a[..., 0::2] << 4) | a[..., 1::2]


def unpack_nibbles(packed, dtype=None):
    """Device-side inverse of pack_nibbles: [..., W/2] → [..., W]."""
    import jax.numpy as jnp

    hi = (packed >> 4) & 0xF
    lo = packed & 0xF
    out = jnp.stack([hi, lo], axis=-1).reshape(packed.shape[:-1] + (-1,))
    return out if dtype is None else out.astype(dtype)


def batched_device_iterator(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    batch_size: int,
    num_workers: int = 4,
    sharding=None,
    pad_to_full: bool = True,
    pack: bool = False,
    on_error: str = "raise",
    with_paths: bool = False,
) -> Iterator[tuple]:
    """Yield (device_batch [B,H,W], count) with decode + transfer pipelined.

    The final short batch is padded by repeating its last plane (count tells
    the consumer how many rows are real) so every step reuses one compiled
    shape.  ``sharding`` (e.g. NamedSharding over the mesh data axis) places
    the batch directly in its sharded layout.  ``pack`` ships label planes
    as 4-bit nibbles (values < 16, even width) — half the host→device bytes;
    the consumer unpacks on device (io.loader.unpack_nibbles).

    ``on_error="skip"`` drops files whose decode fails (logged) instead of
    killing the stream; ``with_paths=True`` appends the tuple of the
    ``count`` real source paths to each yield — REQUIRED under "skip",
    where positional path↔plane alignment no longer holds.
    """
    import jax

    assert with_paths or on_error == "raise", (
        "on_error='skip' shifts plane positions; consume with_paths=True"
    )

    def ship(batch, batch_paths):
        n = len(batch)
        if pad_to_full and n < batch_size:
            batch = batch + [batch[-1]] * (batch_size - n)
        arr = np.stack(batch)
        if pack:
            arr = pack_nibbles(arr)
        dev = jax.device_put(arr, sharding) if sharding is not None \
            else jax.device_put(arr)
        return (dev, n, tuple(batch_paths)) if with_paths else (dev, n)

    batch = []
    batch_paths = []
    pending = None
    for path, plane in prefetch_map_paths(
        load_fn, paths, num_workers=num_workers, prefetch=2 * batch_size,
        on_error=on_error,
    ):
        batch.append(plane)
        batch_paths.append(path)
        if len(batch) == batch_size:
            if pending is not None:
                yield pending
            # transfer overlaps the consumer's compute
            pending = ship(batch, batch_paths)
            batch, batch_paths = [], []
    if batch:
        if pending is not None:
            yield pending
        pending = ship(batch, batch_paths)
    if pending is not None:
        yield pending
