"""Whole-experiment batch pipeline (BASELINE config #5).

Processes arbitrarily many label planes (e.g. 100× 2048²×50 z-stacks) in one
pass: prefetching host loader → sharded/batched fused segmentation on the
mesh → per-plane stat tables → CSV sink, with a restartable manifest.

This is the scale-out replacement for the reference's folder loop
(tiff_analysis.py:1130-1132).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Iterator, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from particle_col_image_segmentation_tpu.config import AnalysisConfig, DEFAULT_CONFIG
from particle_col_image_segmentation_tpu.io.loader import batched_device_iterator
from particle_col_image_segmentation_tpu.ops import (
    compact_labels,
    connected_components,
    median_label_filter,
    region_counts,
)
from particle_col_image_segmentation_tpu.utils.logging import get_logger
from particle_col_image_segmentation_tpu.utils.profiling import stage

_log = get_logger("batch")


def derive_class_values(folder_to_files):
    """{full_path: (particle_val, cell_vals)} via the analyze dispatch rules.

    Single-file folders read strains from the file name (reference
    tiff_analysis.py:85-89,633); multi-file folders read the per-channel
    map from folder strains + file channel token (:102,110).  Paths whose
    names carry no recognizable tokens fall back to (2, (1,)) with a
    warning — the streaming path must not die on one odd file.
    """
    import os

    from particle_col_image_segmentation_tpu.labels import classmaps

    out = {}
    for folder, files in folder_to_files.items():
        for f in files:
            full = os.path.join(folder, f)
            try:
                if len(files) == 1:
                    ct = classmaps.get_cell_type_map(f)
                else:
                    strains = classmaps.get_strains_from_path(folder)
                    channel = classmaps.get_channel_from_path(f)
                    ct = classmaps.get_cell_type_map_from_channel(
                        strains, channel
                    )
                inv = {v: k for k, v in ct.items()}
                cells = tuple(
                    k for k, v in ct.items() if v not in ("Particle", "Background")
                )
                out[full] = (inv["Particle"], cells)
            except (ValueError, KeyError, IndexError) as e:
                # IndexError: get_channel_from_path with no channel token
                # (the reference-faithful :687 behavior)
                _log.warning(
                    "no class map derivable for %s (%s); using defaults", full, e
                )
                out[full] = (2, (1,))
    return out


@dataclasses.dataclass
class PlaneStats:
    """Per-plane headline statistics from the fused pass."""

    num_regions: int
    particle_px: int
    cell_px: int
    class_px: np.ndarray  # [num_classes] pixel histogram
    # True when num_regions > cfg.max_regions: components past capacity were
    # dropped from the tables, so the pixel stats UNDERCOUNT.  Re-run the
    # plane with a larger AnalysisConfig.max_regions.
    overflow: bool = False
    # False when a fixpoint kernel exhausted its iteration budget: the
    # labels (and every stat) are INVALID for this plane.  The plane is not
    # marked done in the manifest, so a re-run (with raised budgets)
    # retries it.
    converged: bool = True


@partial(jax.jit, static_argnames=("cfg", "particle_val", "cell_vals", "packed"))
def fused_segment_batch(
    imgs: jnp.ndarray,
    cfg: AnalysisConfig,
    particle_val: int = 2,
    cell_vals: Tuple[int, ...] = (1,),
    packed: bool = False,
):
    """[B,H,W] → (seg [B,H,W], num [B], area-table [B,R+1], class-table,
    particle_px [B], cell_px [B], class_px [B,num_classes]).

    ``packed``: imgs arrive 4-bit packed [B,H,W/2] (io.loader.pack_nibbles)
    and are unpacked here, inside the jit — half the transfer bytes, no
    extra HBM round trip."""
    if packed:
        from particle_col_image_segmentation_tpu.io.loader import unpack_nibbles

        imgs = unpack_nibbles(imgs, jnp.uint8)
    with jax.named_scope("median"):
        den = median_label_filter(imgs, cfg.denoise_size, cfg.num_classes)
    with jax.named_scope("ccl"):
        raw, converged = connected_components(  # converged: per plane [B]
            den, background=None, num_classes=cfg.num_classes,
            with_flag=True, max_iters=cfg.ccl_max_iters,
        )
    with jax.named_scope("compact"):
        seg, num = compact_labels(raw, cfg.max_regions)
    with jax.named_scope("tables"):
        areas, classes = region_counts(seg, den, cfg.max_regions)
    class_px, particle_px, cell_px = _pixel_stats_from_tables(
        areas, classes, cfg, particle_val, cell_vals
    )
    return seg, num, areas, classes, particle_px, cell_px, class_px, converged


def make_fused_segment_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    packed: bool = False,
):
    """Data-parallel fused pass over a mesh: shard_map over the "data" axis,
    each device running the whole per-plane pipeline shard-locally.

    This (not plain jit over a NamedSharding) is the multi-device path:
    planes are independent, so the decomposition is per-shard execution
    with no cross-device communication at all, and the fixpoint loops'
    per-plane convergence tests never synchronize across devices.
    """
    from jax.sharding import PartitionSpec as P

    from particle_col_image_segmentation_tpu.parallel.mesh import DATA_AXIS

    body = partial(
        fused_segment_batch,
        cfg=cfg,
        particle_val=particle_val,
        cell_vals=tuple(cell_vals),
        packed=packed,
    )
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=(
            P(DATA_AXIS),  # seg
            P(DATA_AXIS),  # num
            P(DATA_AXIS),  # areas
            P(DATA_AXIS),  # classes
            P(DATA_AXIS),  # particle_px
            P(DATA_AXIS),  # cell_px
            P(DATA_AXIS),  # class_px
            P(DATA_AXIS),  # converged
        ),
        # every output is data-varying and the body is communication-free;
        # the replication checker trips on iota seeds inside the fixpoint
        # loops (replicated carry meets varying image), so skip it
        check_vma=False,
    )
    return jax.jit(fn)


def _pixel_stats_from_tables(areas, classes, cfg: AnalysisConfig,
                             particle_val: int, cell_vals):
    """Per-plane pixel histograms reduced over the [R+1] region tables
    (every pixel belongs to exactly one class-homogeneous region, so this
    is O(R) — shared by the fused and space-sharded passes so overflow
    semantics cannot diverge).  Requires num ≤ cfg.max_regions (ids past
    capacity are dropped from the tables); callers check ``num``."""
    class_px = jnp.stack(
        [
            jnp.sum(jnp.where(classes == v, areas, 0), axis=-1)
            for v in range(cfg.num_classes)
        ],
        axis=-1,
    )
    particle_px = class_px[..., particle_val]
    # empty cell_vals (e.g. an RFP plane with no cell class under the
    # 6B07/6B07+C3M10 rules) must still yield a [B] array, not Python 0
    cell_px = (
        sum(class_px[..., v] for v in cell_vals)
        if cell_vals
        else jnp.zeros_like(particle_px)
    )
    return class_px, particle_px, cell_px


def make_space_sharded_segment_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters: Optional[int] = None,
):
    """Spatially sharded fused pass with the SAME output contract as
    ``fused_segment_batch`` — the run_batch step for planes too large for
    one chip (the reference hard-asserts 2048², tiff_analysis.py:734; this
    path removes that ceiling).

    B shards over the mesh "data" axis, plane rows over "space"; the
    distributed CCL/compaction/tables run halo-exchanged inside one
    shard_map (parallel.sharded).  The per-plane pixel stats are recomputed
    from the replicated region tables exactly like the single-device pass,
    so overflow semantics (ids past ``cfg.max_regions`` dropped) match
    bit-for-bit.
    """
    from particle_col_image_segmentation_tpu.parallel.sharded import (
        make_sharded_segment_fn,
    )

    inner = make_sharded_segment_fn(
        mesh, cfg, particle_val=particle_val, cell_vals=tuple(cell_vals),
        max_iters=max_iters if max_iters is not None else cfg.sharded_max_iters,
        with_tables=True,
    )

    @jax.jit
    def fn(imgs):
        (_, _, _, n_comp, _, _, conv, seg, areas, classes) = inner(imgs)
        class_px, particle_px, cell_px = _pixel_stats_from_tables(
            areas, classes, cfg, particle_val, cell_vals
        )
        return seg, n_comp, areas, classes, particle_px, cell_px, class_px, conv

    return fn


def run_batch(
    paths: Sequence[str],
    load_fn: Callable[[str], np.ndarray],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    batch_size: int = 4,
    particle_val: int = 2,
    cell_vals: Tuple[int, ...] = (1,),
    manifest=None,
    sharding=None,
    mesh=None,
    pack_transfer: bool = False,
    on_error: str = "skip",
) -> Iterator[Tuple[str, PlaneStats]]:
    """Stream per-plane stats for every path; skips manifest-completed units.

    Pass ``mesh`` to run data-parallel across devices (shard_map over the
    "data" axis; ``batch_size`` must be a multiple of the axis size).  The
    legacy ``sharding`` argument only places the input batch.

    ``pack_transfer`` ships planes 4-bit packed (half the host→device
    bytes; valid since label values < 16) and unpacks inside the jit —
    useful when the interconnect, not the host, is the bottleneck (the
    numpy packing itself costs ~100 ms per 64 MB batch).

    By default a plane whose decode raises is logged and skipped — one
    corrupt file must not kill a 100k-plane run.  Skipped planes are never
    marked done, so a resume (after fixing the file) retries exactly
    those; callers without a manifest should diff the yielded paths
    against their input (or pass ``on_error="raise"`` to fail fast).
    """
    assert not pack_transfer or cfg.num_classes <= 16
    todo = [p for p in paths if manifest is None or not manifest.is_done(p)]
    if len(todo) < len(paths):
        _log.info("manifest: skipping %d completed planes", len(paths) - len(todo))
    segment_fn = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from particle_col_image_segmentation_tpu.parallel.mesh import (
            DATA_AXIS,
            SPACE_AXIS,
        )

        n_data = mesh.shape[DATA_AXIS]
        n_space = dict(mesh.shape).get(SPACE_AXIS, 1)
        assert batch_size % n_data == 0, (batch_size, n_data)
        if n_space > 1:
            if pack_transfer:
                raise ValueError(
                    "pack_transfer packs along W, which conflicts with the "
                    "space axis sharding rows — ship unpacked on a space mesh"
                )
            segment_fn = make_space_sharded_segment_fn(
                mesh, cfg, particle_val, cell_vals
            )
            sharding = NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS, None))
        else:
            segment_fn = make_fused_segment_fn(
                mesh, cfg, particle_val, cell_vals, packed=pack_transfer
            )
            sharding = NamedSharding(mesh, P(DATA_AXIS))
    it = batched_device_iterator(
        load_fn, todo, batch_size=batch_size, sharding=sharding,
        pack=pack_transfer, on_error=on_error, with_paths=True,
    )
    px_per_row = 2 if pack_transfer else 1  # packed batches are W/2 wide
    for dev_batch, count, batch_paths in it:
        with stage("fused_segment", megapixels=count * px_per_row * dev_batch.shape[-1] * dev_batch.shape[-2] / 1e6):
            if segment_fn is not None:
                out = segment_fn(dev_batch)
            else:
                out = fused_segment_batch(
                    dev_batch, cfg, particle_val, cell_vals,
                    packed=pack_transfer,
                )
        _, num, _, _, particle_px, cell_px, class_px, converged = out
        # ONE host readback per batch: each np.asarray is a device sync,
        # so the per-plane scalars ride a single packed [B, 4+C] array
        stats_dev = jnp.concatenate(
            [num[:, None], particle_px[:, None], cell_px[:, None],
             converged[:, None].astype(num.dtype), class_px],
            axis=-1,
        )
        stats_host = np.asarray(stats_dev)
        num = stats_host[:, 0]
        particle_px = stats_host[:, 1]
        cell_px = stats_host[:, 2]
        conv_host = stats_host[:, 3]
        class_px = stats_host[:, 4:]
        for b in range(count):
            path = batch_paths[b]
            converged = bool(conv_host[b])
            if not converged:
                _log.error(
                    "%s: CCL exhausted its iteration budget — "
                    "stats INVALID for this plane; not marking done "
                    "(pathological geometry; raise "
                    "AnalysisConfig.ccl_max_iters)", path,
                )
            overflow = int(num[b]) > cfg.max_regions
            if overflow:
                _log.warning(
                    "%s: %d components > max_regions=%d — stats undercount; "
                    "not marking done, so a re-run with a larger "
                    "AnalysisConfig.max_regions retries this plane",
                    path, int(num[b]), cfg.max_regions,
                )
            stats = PlaneStats(
                num_regions=int(num[b]),
                particle_px=int(particle_px[b]),
                cell_px=int(cell_px[b]),
                class_px=class_px[b],
                overflow=overflow,
                converged=converged,
            )
            # yield FIRST, mark done after: if the consumer crashes while
            # recording this plane (CSV write, etc.) the plane stays
            # unmarked and a resume retries it — at-least-once, never a
            # done-but-unrecorded gap.  Overflowed planes are also left
            # unmarked: their stats undercount, and the documented remedy
            # (resume with a larger max_regions) only works if the resume
            # does not skip them as done.
            yield path, stats
            if manifest is not None and converged and not overflow:
                meta = {
                    "regions": stats.num_regions,
                    "particle_px": stats.particle_px,
                }
                manifest.mark_done(path, meta=meta)
