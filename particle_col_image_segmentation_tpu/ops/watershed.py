"""Marker-based watershed as an XLA fixpoint (two-phase minimax flooding).

Replaces skimage.segmentation.watershed (reference: refine_boundaries.py:73)
with an iteration-order-independent formulation in two confluent phases:

  1. **costs**: every masked pixel's minimax distance to the seed set —
     min over paths of the maximum relief along the path (Bellman-Ford-style
     relaxation of a min/max semilattice → unique fixpoint);
  2. **labels**: with costs FIXED, propagate labels through "optimal edges"
     (n → p is optimal iff max(cost[n], img[p]) == cost[p]), choosing each
     pixel's claimer by the lexicographic key

         (level distance, entry img, claimer img, marker id)

     where *level distance* is the geodesic step count since the claim chain
     last crossed strictly-uphill cost (reset to 0 on cost[n] < cost[p]
     edges), *entry img* is the relief value of the neighbor that fed that
     uphill crossing, and *claimer img* is the relief under the claiming
     neighbor itself.

The key models skimage's priority-flood arrival order: a pixel is claimed
by the first POPPED neighbor, pops are ordered by (img, heap age), and on an
equal-cost level all entry pixels are enqueued before any flooding starts —
so the flood is a level-synchronized BFS from the entries (level distance),
entries ordered by the pop priority of the pixel that claimed them (entry
img), direct claims preferring lower-relief claimers (claimer img), with
marker id approximating residual heap-age ties (markers are raster-ordered,
as are skimage's seed ages).  Measured boundary IoU vs the priority-flood
oracle: 0.977→0.998 on the bench fixture and ≥0.99 on every smooth-relief
fixture vs 0.971 for the previous (global distance, id) key.

Phase 2 is a *recompute-from-scratch* relaxation (each step rebuilds every
pixel's claim from its neighbors' current states, rather than ratcheting),
because the level-reset makes single-pixel updates non-monotone; the
justification graph is still acyclic (cost strictly increases across
resets, level distance strictly increases within a level), so the fixpoint
is unique and any schedule — single-device Jacobi, sharded
halo-exchange — produces bit-identical labels.  Agreement with
skimage's sequential priority flood is by boundary IoU (exact queue-order
ties still differ; BASELINE.json contract).

``tunnel_basins=True`` (XLA schedule only) additionally models **basin
tunneling**: in the priority flood, a below-level pixel (img < flood
level) pops before every at-level pixel, so a wave touching a basin rim
floods the entire basin within one BFS round — geodesic distance across a
basin is ~1 regardless of its width (hand-traced golden
`test_quantized_basin_tunnels_wave`).  Naive zero-increment steps make
the justification graph cyclic (intra-basin zero edges sustain phantom
states; recorded negative in PERF.md), so this mode *contracts* each
basin instead: adjacent below-level pixels provably share one flood level
(cost[p] < cost[q] would force cost[q] ≤ img[q], contradicting
img[q] < cost[q]), so the connected components of the below-level mask
are per-level basins.  Claims flow only across component boundaries, the
level distance increments only onto at-level pixels, and every basin
adopts the lexicographic-min external candidate via a segment-min
broadcast each step.  Any constant-cost justification cycle would then
have to alternate basin→at-level hops, each costing +1 — so the quotient
graph is acyclic and the relaxation converges.  Measured on 256² sparse
point-seed fixtures vs the priority-flood oracle (scripts/ws_key_lab.py):
boundary IoU 0.46→0.96 (smooth, 8-level-quantized), 0.26→0.67 (noise
relief), unchanged parity on the pipeline regime, in ~half the sweeps.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["watershed"]

_INF = 3.4e38
_BIG_LAB = jnp.iinfo(jnp.int32).max


def _offsets(connectivity: int):
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    return offsets


def _shifted(x, dy, dx, fill):
    H, W = x.shape[-2:]
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
    return jnp.full(x.shape, fill, x.dtype).at[sl_dst].set(x[sl_src])


def claim_candidates(cost, img, lab, dist, eimg, dy, dx, shifted,
                     inc=1, seg=None):
    """One optimal-edge candidate set for the phase-2 claim relaxation.

    Shared by every schedule (single-device Jacobi, sharded halo
    exchange) AND the tunnel-basins quotient graph, so the lexicographic
    key is defined in exactly one place.  ``shifted(x, dy, dx, fill)``
    supplies the neighbor view.  ``inc`` is the per-hop level-distance
    increment (1 for the pixel graph; ``at_level`` for the basin quotient,
    where intra-basin hops are free).  ``seg`` restricts candidates to
    external edges of a segment image (quotient graph).  Returns
    (cd, ce, cs, cl): level distance, entry img, claimer img, label.
    """
    nc = shifted(cost, dy, dx, jnp.float32(_INF))
    nim = shifted(img, dy, dx, jnp.float32(_INF))
    nl = shifted(lab, dy, dx, _BIG_LAB)
    nd = shifted(dist, dy, dx, _BIG_LAB)
    ne = shifted(eimg, dy, dx, jnp.float32(_INF))
    valid = (jnp.maximum(nc, img) == cost) & (nl != _BIG_LAB)
    if seg is not None:
        nseg = shifted(seg, dy, dx, jnp.int32(-1))
        valid &= nseg != seg  # quotient graph: external edges only
    reset = nc < cost  # strictly-uphill crossing: new flooding level
    cd = jnp.where(
        valid,
        jnp.where(reset, 0, jnp.where(nd < _BIG_LAB, nd + inc, _BIG_LAB)),
        _BIG_LAB,
    )
    ce = jnp.where(
        valid, jnp.where(reset, nim, ne), jnp.float32(_INF)
    )
    cs = jnp.where(valid, nim, jnp.float32(_INF))
    cl = jnp.where(valid, nl, _BIG_LAB)
    return cd, ce, cs, cl


def fold_claim(best, cand):
    """Lexicographic (d, eimg, simg, lab) min-fold of one candidate set."""
    bd, be, bs, bl = best
    cd, ce, cs, cl = cand
    take = (
        (cd < bd)
        | ((cd == bd) & (ce < be))
        | ((cd == bd) & (ce == be) & (cs < bs))
        | ((cd == bd) & (ce == be) & (cs == bs) & (cl < bl))
    )
    return (
        jnp.where(take, cd, bd),
        jnp.where(take, ce, be),
        jnp.where(take, cs, bs),
        jnp.where(take, cl, bl),
    )


@partial(
    jax.jit,
    static_argnames=("connectivity", "max_iters", "with_flag", "tunnel_basins"),
)
def watershed(
    image: jnp.ndarray,
    markers: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    connectivity: int = 1,
    max_iters: int = 1024,
    with_flag: bool = False,
    tunnel_basins: bool = False,
) -> jnp.ndarray:
    """Flood ``markers`` over the relief ``image`` within ``mask``.

    Args:
      image: [..., H, W] relief (e.g. boundary probability); a leading
        batch axis floods every plane in one fixpoint loop (extra Jacobi
        steps after a plane converges are no-ops, so each plane's labels
        are bit-identical to its single-plane run).
      markers: [..., H, W] int marker labels (>0 seeds, 0 elsewhere).
      mask: optional [..., H, W] bool; pixels outside stay 0.
      connectivity: 1 (4-neighbors, skimage default) or 2 (8).
      with_flag: also return a bool ``converged`` with the batch shape
        (scalar for a single plane, [B] for a batch — each plane's own
        verdict) — False means a phase hit ``max_iters`` with work left on
        THAT plane (huge/winding basins); unreached in-mask pixels would
        then silently read 0, so callers must surface it.
      tunnel_basins: model priority-flood basin tunneling via
        basin-component contraction (module docstring).  Improves parity
        on plateaued/quantized reliefs with sparse markers; the default
        key is already ≥0.99 on the pipeline regime.  Costs one CCL over
        the below-level mask plus four segment-mins per sweep (transient
        [#pixels] buffers — prefer modest plane counts per call).

    Returns [..., H, W] int32 labels.
    """
    img = image.astype(jnp.float32)
    lab0 = markers.astype(jnp.int32)
    m = jnp.ones(image.shape, bool) if mask is None else mask.astype(bool)
    seeded = (lab0 > 0) & m
    cost0 = jnp.where(seeded, img, jnp.float32(_INF))
    offsets = _offsets(connectivity)

    # ---- phase 1: minimax costs --------------------------------------
    batch_shape = image.shape[:-2]

    def cost_body(state):
        cost, _, i = state
        best = cost
        for dy, dx in offsets:
            nc = _shifted(cost, dy, dx, jnp.float32(_INF))
            best = jnp.minimum(best, jnp.maximum(nc, img))
        new = jnp.where(seeded, cost0, jnp.where(m, best, jnp.float32(_INF)))
        # per-plane change tracking: at loop exit this marks exactly the
        # planes still changing when the budget ran out (all-False on a
        # converged exit), so batched callers can name the failing plane
        return new, jnp.any(new != cost, axis=(-2, -1)), i + 1

    def cond(state):
        _, changed, i = state
        return jnp.any(changed) & (i < max_iters)

    cost, c_changed, _ = jax.lax.while_loop(
        cond, cost_body, (cost0, jnp.ones(batch_shape, bool), 0)
    )

    # ---- phase 2: claim relaxation (see module docstring) ------------
    neg_inf = jnp.float32(-_INF)
    lab_init = jnp.where(seeded, lab0, _BIG_LAB)
    dist_init = jnp.where(seeded, 0, _BIG_LAB)
    eimg_init = jnp.where(seeded, neg_inf, jnp.float32(_INF))

    basin_conv = jnp.ones(batch_shape, bool)
    if tunnel_basins:
        from particle_col_image_segmentation_tpu.ops.ccl import (
            connected_components,
        )

        H, W = image.shape[-2:]
        at_level = img == cost
        below = m & ~seeded & ~at_level & (cost < _INF)
        comp, basin_conv = connected_components(
            below.astype(jnp.int32),
            background=0,
            connectivity=4 if connectivity == 1 else 8,
            num_classes=2,  # binary mask: 4× less _neighbor_min volume
            with_flag=True,
        )
        lin = (
            jax.lax.broadcasted_iota(jnp.int32, image.shape, image.ndim - 2)
            * W
            + jax.lax.broadcasted_iota(jnp.int32, image.shape, image.ndim - 1)
        )
        # globally-unique segment ids: per-plane basin labels (min linear
        # index of the component — always a below-level pixel, so it never
        # collides with an at-level pixel's own index) + plane offsets
        seg = jnp.where(below, comp, lin)
        n_total = math.prod(image.shape)
        plane_off = (
            jnp.arange(n_total // (H * W), dtype=jnp.int32) * (H * W)
        ).reshape((-1, 1, 1))
        seg = (seg.reshape((-1, H, W)) + plane_off).reshape(image.shape)
        inc = at_level.astype(jnp.int32)

        seg_flat = seg.reshape(-1)

        def seg_broadcast(bd, be, bs, bl):
            """Lexicographic (d, e, s, lab) min per segment, gathered back."""
            d, e, c, l = (x.reshape(-1) for x in (bd, be, bs, bl))
            dm = jax.ops.segment_min(d, seg_flat, num_segments=n_total)[
                seg_flat
            ]
            t = d == dm
            em = jax.ops.segment_min(
                jnp.where(t, e, jnp.float32(_INF)), seg_flat,
                num_segments=n_total,
            )[seg_flat]
            t &= e == em
            cm = jax.ops.segment_min(
                jnp.where(t, c, jnp.float32(_INF)), seg_flat,
                num_segments=n_total,
            )[seg_flat]
            t &= c == cm
            lm = jax.ops.segment_min(
                jnp.where(t, l, _BIG_LAB), seg_flat, num_segments=n_total
            )[seg_flat]
            return (
                dm.reshape(image.shape),
                em.reshape(image.shape),
                lm.reshape(image.shape),
            )

    def lab_body(state):
        lab, dist, eimg, _, i = state
        best = (
            jnp.full(image.shape, _BIG_LAB, jnp.int32),
            jnp.full(image.shape, _INF, jnp.float32),
            jnp.full(image.shape, _INF, jnp.float32),
            jnp.full(image.shape, _BIG_LAB, jnp.int32),
        )
        for dy, dx in offsets:
            if tunnel_basins:
                cand = claim_candidates(
                    cost, img, lab, dist, eimg, dy, dx, _shifted,
                    inc=inc, seg=seg,
                )
            else:
                cand = claim_candidates(
                    cost, img, lab, dist, eimg, dy, dx, _shifted
                )
            best = fold_claim(best, cand)
        bd, be, bs, bl = best
        if tunnel_basins:
            bd, be, bl = seg_broadcast(bd, be, bs, bl)
        new_l = jnp.where(seeded, lab0, jnp.where(m, bl, _BIG_LAB))
        new_d = jnp.where(seeded, 0, jnp.where(m, bd, _BIG_LAB))
        new_e = jnp.where(seeded, neg_inf, jnp.where(m, be, jnp.float32(_INF)))
        ch = (
            jnp.any(new_l != lab, axis=(-2, -1))
            | jnp.any(new_d != dist, axis=(-2, -1))
            | jnp.any(new_e != eimg, axis=(-2, -1))
        )
        return new_l, new_d, new_e, ch, i + 1

    def lab_cond(state):
        _, _, _, changed, i = state
        return jnp.any(changed) & (i < max_iters)

    lab, _, _, l_changed, _ = jax.lax.while_loop(
        lab_cond, lab_body,
        (lab_init, dist_init, eimg_init, jnp.ones(batch_shape, bool), 0),
    )
    reached = m & (cost < _INF) & (lab != _BIG_LAB)
    out = jnp.where(reached, lab, 0)
    if with_flag:
        return out, ~(c_changed | l_changed) & basin_conv
    return out
