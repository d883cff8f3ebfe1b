"""Watershed boundary refinement (refine_boundaries.py parity + completion).

The reference prototype (78 LoC, self-described unfinished at :54) does:
probability export → boundary channel → binary mask (prob < 0.5) → EDT →
local maxima → labeled markers → watershed.  Its docstring (:2-12) states
the unfinished goals: recompute per-cell areas/positions and compute same- /
cross-strain nearest-neighbor distances.  This module implements the full
flow as one jit graph, including those stated goals.

Parity note: skimage's priority-flood tie-breaking is inherently sequential;
our order-independent minimax flooding can differ on plateau pixels, which is
why BASELINE.json measures watershed parity as boundary IoU.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from particle_col_image_segmentation_tpu.config import RefineConfig
from particle_col_image_segmentation_tpu.ops import (
    centroid_sums,
    centroids_f64,
    compact_labels,
    connected_components,
    edt_sq,
    edt_sq_exact_auto,
    local_maxima,
    watershed,
)
from particle_col_image_segmentation_tpu.ops.pairwise import (
    min_dist_to_set,
    nearest_neighbor_dists,
)


@partial(jax.jit, static_argnames=("cfg", "max_regions"))
def refine_plane_device(
    boundary_map: jnp.ndarray, cfg: RefineConfig, max_regions: int = 4095
):
    """probability map [..., H, W] → (labels, markers, num_cells, table,
    distance).  Every stage is batch-polymorphic, so a [Z, H, W] stack
    floods all planes in ONE jit graph — the BASELINE config #3
    "touching-particle stack" workload (each plane's labels are
    bit-identical to its single-plane run).  Region tables hold
    ``max_regions + 1`` rows (row 0 is background)."""
    binary_mask = boundary_map < cfg.boundary_threshold  # reference :44-45
    # reference :60: scipy edt(binary_mask) = distance of object pixels to
    # the nearest boundary pixel; our edt measures distance TO the feature
    # set, so the feature is the complement.  EXACT by default: a capped
    # transform saturates deep regions into one plateau that local_maxima
    # would merge into a single giant marker (cfg.edt_cap opts into the
    # cheaper capped path for provably-shallow planes).
    with jax.named_scope("edt"):
        if cfg.edt_cap is None:
            # certified-exact: capped fast path + runtime exactness
            # certificate, lax.cond fallback to the full min-plus
            # (bit-identical either way)
            dsq = edt_sq_exact_auto(~binary_mask, probe_cap=cfg.edt_probe_cap)
        else:
            dsq = edt_sq(~binary_mask, cap=cfg.edt_cap)
        distance = jnp.sqrt(dsq.astype(jnp.float32))
    # maxima of d² == maxima of d (sqrt is monotone), but int32 d² compares
    # are cheaper AND exact: once d exceeds ~2900 px (d² ≈ 8.4M, reachable
    # on the reference's 2048² planes), ADJACENT squared distances round to
    # the SAME f32 sqrt, merging plateaus scipy's f64 keeps distinct
    with jax.named_scope("maxima"):
        maxima, conv_max = local_maxima(dsq, with_flag=True)
    with jax.named_scope("ccl"):
        raw, conv_ccl = connected_components(
            maxima.astype(jnp.uint8), background=0, num_classes=2,
            with_flag=True,
        )
    with jax.named_scope("compact"):
        markers, num = compact_labels(raw, max_regions)
    with jax.named_scope("watershed"):
        # tunnel_basins: basin-contraction claim key (ops.watershed
        # docstring)
        labels, conv_ws = watershed(
            boundary_map.astype(jnp.float32), markers, binary_mask,
            max_iters=cfg.watershed_max_iters, with_flag=True,
            tunnel_basins=cfg.tunnel_basins,
        )
    with jax.named_scope("tables"):
        # the refine outputs read only area + centroid sums (cells are all
        # class 1) — the 5-column CentroidTable skips the value channel
        # and the bbox extremes of the full RegionTable
        table = centroid_sums(labels, max_regions)
    converged = conv_max & conv_ccl & conv_ws
    return labels, markers, num, table, distance, converged


@dataclasses.dataclass
class RefineResult:
    labels: np.ndarray  # [H,W] per-cell labels after watershed split
    num_cells: int
    areas: np.ndarray  # [num_cells] px²
    centroids: np.ndarray  # [num_cells, 2] (row, col) float64
    nn_distances: np.ndarray  # [num_cells] same-set nearest-neighbor, px


def refine_boundaries(
    probabilities: np.ndarray,
    cfg: RefineConfig = RefineConfig(),
    max_regions: int = 4095,
) -> RefineResult:
    """Full refinement of an Ilastik probability export.

    Accepts the raw export with channels on either end — [C,H,W] (the
    reference's indexing, refine_boundaries.py:34) or [H,W,C] (Ilastik's
    usual hdf5 axis order) — or an [H,W] boundary map.  The channel axis is
    whichever end is small enough to be one (≤ 8), preferring the
    reference's axis-0 read when both qualify.
    """
    arr = _extract_boundary_channel(np.asarray(probabilities), cfg, ndim=2)
    labels, _, num, table, _, converged = refine_plane_device(
        jnp.asarray(arr, jnp.float32), cfg, max_regions
    )
    if not bool(converged):
        raise RuntimeError(
            "refine fixpoints (CCL/compaction/watershed) did not converge "
            "within the kernel iteration budgets — labels are invalid"
        )
    n = int(num)
    if n > max_regions:
        raise ValueError(f"{n} cells > max_regions={max_regions}")
    cy, cx = centroids_f64(table)
    pts = np.stack([cy, cx], axis=1)[1 : n + 1]
    areas = np.asarray(table.area)[1 : n + 1]
    if n > 1:
        nn = np.asarray(
            nearest_neighbor_dists(
                jnp.asarray(pts, jnp.float32), jnp.ones((n,), bool)
            )
        )
    else:
        nn = np.full((n,), np.inf, np.float32)
    return RefineResult(
        labels=np.asarray(labels),
        num_cells=n,
        areas=areas,
        centroids=pts,
        nn_distances=nn,
    )


def _reject_channel_last_plane(probs: np.ndarray) -> None:
    """Stack entry points must reject a SINGLE [H, W, C] channel-last
    export (Ilastik's usual axis order): flooding it as H planes of
    [W, C] would silently produce garbage — shared so the heuristic
    cannot drift between the stack entry points."""
    if probs.ndim == 3 and probs.shape[-1] <= 8:
        raise ValueError(
            f"shape {probs.shape} looks like a single [H, W, C] plane "
            "(trailing axis <= 8 can only be channels) — refine it as a "
            "single plane (refine_boundaries / stack=False), or pass a "
            "[Z, H, W(, C)] stack"
        )


def _extract_boundary_channel(arr: np.ndarray, cfg: RefineConfig, ndim: int):
    """Strip the (small, ≤ 8) channel axis off either end, reference-axis
    first — shared by the plane and stack entry points (``ndim`` = expected
    spatial rank of the result)."""
    if arr.ndim == ndim + 1:
        # the non-trailing channel axis sits just before (H, W) in both
        # [C, H, W] and [Z, C, H, W] layouts
        if arr.shape[-3] <= 8:
            arr = arr[..., cfg.boundary_channel, :, :]
        elif arr.shape[-1] <= 8:
            arr = np.ascontiguousarray(arr[..., cfg.boundary_channel])
        else:
            raise ValueError(f"No channel axis of size <= 8 in shape {arr.shape}")
    elif arr.ndim != ndim:
        raise ValueError(f"expected rank {ndim} or {ndim + 1}, got {arr.shape}")
    return arr


def refine_boundaries_stack(
    probabilities: np.ndarray,
    cfg: RefineConfig = RefineConfig(),
    max_regions: int = 4095,
) -> "list[RefineResult]":
    """Refine a whole probability STACK in one device graph.

    Accepts [Z, H, W], [Z, C, H, W], or [Z, H, W, C] (Ilastik exports a
    z-stack in one ``exported_data`` dataset); all planes flood in a single
    jit — one launch and full VPU utilization instead of Z round trips
    (BASELINE config #3's "touching-particle stack").  Per-plane results
    are bit-identical to ``refine_boundaries`` on each plane.
    """
    probs = np.asarray(probabilities)
    _reject_channel_last_plane(probs)
    arr = _extract_boundary_channel(probs, cfg, ndim=3)
    labels, _, num, table, _, converged = refine_plane_device(
        jnp.asarray(arr, jnp.float32), cfg, max_regions
    )
    _check_stack_converged(converged)
    return _assemble_stack_results(
        np.asarray(labels), np.asarray(num), table, max_regions
    )


def _check_stack_converged(converged) -> None:
    conv = np.atleast_1d(np.asarray(converged))
    if not conv.all():
        bad = np.nonzero(~conv)[0].tolist()
        raise RuntimeError(
            f"refine fixpoints did not converge on plane(s) {bad} within "
            "the kernel iteration budgets — labels are invalid"
        )


def _assemble_stack_results(
    labels_np: np.ndarray, nums: np.ndarray, table, max_regions: int
) -> "list[RefineResult]":
    """RefineResults from stacked device outputs (shared by the single-chip
    and space-sharded stack paths; ``table`` needs area/sr_hi/sr_lo/sc_hi/
    sc_lo fields — a full RegionTable or the sharded 5-column sums)."""
    cy, cx = centroids_f64(table)  # [Z, R+1] each
    areas_all = np.asarray(table.area)
    Z = labels_np.shape[0]
    max_n = int(nums.max()) if Z else 0
    if max_n > max_regions:
        bad = int(np.argmax(nums))
        raise ValueError(
            f"plane {bad}: {int(nums[bad])} cells > max_regions={max_regions}"
        )
    # ONE vmapped NN call over valid-masked fixed-size points: per-plane
    # calls would retrace the jitted kernel for every distinct cell count
    # (cap rounded to a power of two so recompiles stay rare across stacks)
    cap = 1 << max(1, int(max(max_n, 1) - 1).bit_length())
    pts_all = np.zeros((Z, cap, 2), np.float32)
    valid_all = np.zeros((Z, cap), bool)
    for z in range(Z):
        n = int(nums[z])
        pts_all[z, :n] = np.stack([cy[z], cx[z]], axis=1)[1 : n + 1]
        valid_all[z, :n] = True
    nn_all = np.asarray(jax.vmap(nearest_neighbor_dists)(
        jnp.asarray(pts_all), jnp.asarray(valid_all)
    ))
    results = []
    for z in range(Z):
        n = int(nums[z])
        pts = np.stack([cy[z], cx[z]], axis=1)[1 : n + 1]
        results.append(RefineResult(
            labels=labels_np[z], num_cells=n,
            areas=areas_all[z][1 : n + 1], centroids=pts,
            nn_distances=nn_all[z, :n],
        ))
    return results


def refine_boundaries_sharded(
    probabilities: np.ndarray,
    cfg: RefineConfig = RefineConfig(),
    max_regions: int = 4095,
    mesh=None,
    stack: "bool | None" = None,
) -> "list[RefineResult]":
    """Space-sharded refine: plane rows shard across the mesh "space" axis,
    planes across "data" — the path for probability maps too large for one
    chip (and the CLI's ``refine --space-parallel``).

    ``stack`` selects the input interpretation exactly like the CLI flag:
    False → a single plane ([H,W] / [C,H,W] / [H,W,C], refine_boundaries
    semantics, returned as a 1-element list); True → a z-stack ([Z,H,W] /
    [Z,C,H,W] / [Z,H,W,C], refine_boundaries_stack semantics); None
    (default) → stack iff 4-D.  Z is padded to a multiple of the data-axis
    size by repeating the last plane (padding results are dropped).  The
    EDT is always exact on this path (``cfg.edt_cap`` does not apply).
    Per-plane labels are bit-identical to ``refine_plane_device`` (tested
    on the 8-virtual-device CPU mesh).

    ``cfg.tunnel_basins`` composes as DATA parallelism only: the tunneled
    claim key has no halo-exchange schedule, so planes distribute over all
    mesh devices and each floods single-device (each plane must fit one
    chip; see ``_refine_tunnel_data_parallel``).
    """
    from particle_col_image_segmentation_tpu.parallel.mesh import (
        DATA_AXIS,
        make_mesh,
    )
    from particle_col_image_segmentation_tpu.parallel.sharded import (
        make_sharded_refine_fn,
    )

    probs = np.asarray(probabilities)
    if stack is None:
        stack = probs.ndim == 4
    if stack:
        _reject_channel_last_plane(probs)
        arr = _extract_boundary_channel(probs, cfg, ndim=3)
    else:
        arr = _extract_boundary_channel(probs, cfg, ndim=2)[None]
    if mesh is None:
        mesh = make_mesh()
    if cfg.tunnel_basins:
        # The tunneled claim key has no halo-exchange schedule: each sweep
        # contracts the below-level basin components and broadcasts a
        # 4-pass segment-min over them, which sharded would need a global
        # CCL + cross-shard segment reduction per sweep.  Documented
        # contract instead: planes distribute over ALL mesh devices
        # DATA-parallel, each plane flooding on one device through the
        # single-chip tunneled graph (bit-identical to refine_boundaries
        # per plane, tested on the 8-virtual-device mesh).  Each plane
        # must therefore fit one chip — for a plateau-heavy export too
        # large for that, quantize-aware single-chip tiling does not
        # exist yet; raise the honest limit rather than silently degrade.
        return _refine_tunnel_data_parallel(arr, cfg, max_regions, mesh)
    n_data = mesh.shape[DATA_AXIS]
    Z = arr.shape[0]
    pad = (-Z) % n_data
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    fn = make_sharded_refine_fn(
        mesh, threshold=cfg.boundary_threshold, max_regions=max_regions,
        with_tables=True,
    )
    labels, _, num, converged, sums = fn(jnp.asarray(arr, jnp.float32))
    _check_stack_converged(np.asarray(converged)[:Z])
    sums_np = np.asarray(sums)

    class _Sums:
        area = sums_np[:Z, :, 0]
        sr_hi = sums_np[:Z, :, 1]
        sr_lo = sums_np[:Z, :, 2]
        sc_hi = sums_np[:Z, :, 3]
        sc_lo = sums_np[:Z, :, 4]

    return _assemble_stack_results(
        np.asarray(labels)[:Z], np.asarray(num)[:Z], _Sums, max_regions
    )


# Tunneled-graph working set, bytes per pixel per plane: ~9 persistent
# full-plane f32/i32 buffers (img, cost, lab, dist, eimg, seg, inc, masks)
# plus the claim fold's 4-tuple candidates ×2 and the 4-pass segment-min
# flats live concurrently inside the relaxation body — ~30 buffers × 4 B,
# rounded up to 128 to absorb XLA temporaries.  Deliberately generous:
# tripping early costs a clearer error; tripping late costs a device OOM.
_TUNNEL_BYTES_PER_PX = 128


def _check_tunnel_chunk_fits(plane_shape, planes_per_device, device) -> None:
    """Targeted size guard for the tunneled data-parallel refine: a plateau-
    heavy export too large for one chip would otherwise head straight for a
    device OOM (the tunneled claim key is single-device only — see
    refine_boundaries_sharded's docstring).  Raises with the documented
    alternatives instead."""
    H, W = plane_shape
    need = H * W * planes_per_device * _TUNNEL_BYTES_PER_PX
    stats = device.memory_stats()
    limit = stats.get("bytes_limit") if stats else None
    if limit is None:
        # the device reports no memory size (the CPU backend): there is
        # nothing to check against, so the guard is skipped
        return
    if need > limit:
        raise ValueError(
            f"tunnel_basins chunk ({planes_per_device} plane(s) of {H}x{W}, "
            f"~{need / 1e9:.1f} GB working set) exceeds one device's memory "
            f"(~{limit / 1e9:.1f} GB); the tunneled claim key runs single-"
            "device only.  Alternatives: (a) untunneled sharded refine "
            "(tunnel_basins=False — rows shard across the mesh; the default "
            "key is >=0.99 IoU in the pipeline regime), or (b) tile the "
            "plane and refine tiles independently if its basins are local."
        )


def _refine_tunnel_data_parallel(
    arr: np.ndarray, cfg: RefineConfig, max_regions: int, mesh
) -> "list[RefineResult]":
    """``refine --space-parallel --tunnel-basins``: plane chunks dispatch
    to each mesh device explicitly and run the single-chip tunneled graph
    there (the stages are plane-local, so this needs no collectives; JAX's
    async dispatch overlaps the per-device executions).  Z pads to a
    device-count multiple by repeating the last plane (results dropped)."""
    devs = list(mesh.devices.reshape(-1))
    n_dev = len(devs)
    Z = arr.shape[0]
    pad = (-Z) % n_dev
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    per = arr.shape[0] // n_dev
    _check_tunnel_chunk_fits(arr.shape[-2:], per, devs[0])
    outs = []
    for i, dev in enumerate(devs):
        chunk = jax.device_put(
            jnp.asarray(arr[i * per : (i + 1) * per], jnp.float32), dev
        )
        outs.append(refine_plane_device(chunk, cfg, max_regions))
    labels = np.concatenate([np.asarray(o[0]) for o in outs])
    num = np.concatenate([np.asarray(o[2]) for o in outs])
    table_np = jax.tree.map(
        lambda *ts: np.concatenate([np.asarray(t) for t in ts])[:Z],
        *(o[3] for o in outs),
    )
    converged = np.concatenate([np.atleast_1d(np.asarray(o[5])) for o in outs])
    _check_stack_converged(converged[:Z])
    return _assemble_stack_results(
        labels[:Z], num[:Z], table_np, max_regions
    )


def _refine_rows(result: RefineResult, prefix: tuple = ()):
    """One row per cell (shared by the plane and stack CSV writers so the
    rounding / inf-sentinel format cannot diverge)."""
    for i in range(result.num_cells):
        cy, cx = result.centroids[i]
        nn = result.nn_distances[i]
        yield [*prefix, i + 1, round(float(cx), 2), round(float(cy), 2),
               int(result.areas[i]),
               "" if not np.isfinite(nn) else round(float(nn), 3)]


def write_refine_stack_csv(results: "list[RefineResult]", path: str) -> None:
    """Per-cell table across a refined stack (plane column + the
    write_refine_csv schema)."""
    import csv

    with open(path, "w") as f:
        w = csv.writer(f)
        w.writerow(["plane", "cell", "x_pos", "y_pos", "area_px",
                    "nn_distance_px"])
        for z, result in enumerate(results):
            w.writerows(_refine_rows(result, prefix=(z,)))


def write_refine_csv(result: RefineResult, path: str) -> None:
    """Per-cell table for the refined segmentation: the reference docstring's
    goal (2) deliverable (cell id, position, area, nearest-neighbor px)."""
    import csv

    with open(path, "w") as f:
        w = csv.writer(f)
        w.writerow(["cell", "x_pos", "y_pos", "area_px", "nn_distance_px"])
        w.writerows(_refine_rows(result))


def cross_strain_distances(
    a_centroids: np.ndarray, b_centroids: np.ndarray
) -> Dict[str, np.ndarray]:
    """Goal (3b) of the reference docstring: each cell's distance to the
    nearest cell of the *other* strain, both directions."""
    a = jnp.asarray(a_centroids, jnp.float32)
    b = jnp.asarray(b_centroids, jnp.float32)
    return {
        "a_to_b": np.asarray(min_dist_to_set(a, b, jnp.ones((b.shape[0],), bool))),
        "b_to_a": np.asarray(min_dist_to_set(b, a, jnp.ones((a.shape[0],), bool))),
    }
