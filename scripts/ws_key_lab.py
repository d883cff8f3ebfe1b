"""Watershed claim-key experiments (VERDICT r2 #4).

Self-contained phase-1/phase-2 implementations with variant claim rules,
measured (boundary IoU vs the oracle priority flood) across the
quantization fixtures of ws_quant_curve.py.  Variants:

  base         the shipping key: d resets on uphill cost crossings,
               increments on every same-cost step; key (d, e, cs, lab)
  tunnel       d increments ONLY on steps onto pixels at their flood level
               (img == cost); basin-interior steps are free, modeling the
               priority flood's "a basin touched in round t floods
               entirely before round t+1" tunneling; key (d, e, cs, lab)
  tunnel_dreal tunnel + a real hop counter in the key tail:
               key (d, e, cs, d_real, lab) — d_real strictly increases
               along every claim edge, making the justification graph
               provably acyclic even where tunnel ties
  basin        SOUND full tunneling via basin-component contraction:
               below-level pixels (img < cost) are CCL-grouped (adjacent
               below-level pixels provably share one cost, so components
               are per-level basins); claims flow only across component
               boundaries (external edges), and each basin adopts the
               lexicographic-min external candidate via segment-min
               broadcast every step.  Zero-increment edges then cannot
               form cycles (any constant-cost cycle must alternate
               basin→at-level hops, each +1), so the recompute relaxation
               converges to a unique fixpoint — unlike `tunnel`, whose
               intra-basin zero edges sustain phantom states.

Run: JAX_PLATFORMS=cpu python scripts/ws_key_lab.py [n]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from functools import partial  # noqa: E402
from scipy import ndimage as ndi  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from particle_col_image_segmentation_tpu.oracle import ndimage as ond  # noqa: E402
from particle_col_image_segmentation_tpu.ops.watershed import (  # noqa: E402
    _offsets,
    _shifted,
)
from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou  # noqa: E402

from ws_quant_curve import fixtures, quantize  # noqa: E402

_INF = 3.4e38
_BIG = jnp.iinfo(jnp.int32).max


@partial(jax.jit, static_argnames=("variant", "max_iters"))
def ws_variant(image, markers, mask, variant: str, max_iters: int = 4096):
    img = image.astype(jnp.float32)
    lab0 = markers.astype(jnp.int32)
    m = mask.astype(bool)
    seeded = (lab0 > 0) & m
    cost0 = jnp.where(seeded, img, jnp.float32(_INF))
    offsets = _offsets(1)

    def cost_body(state):
        cost, _, i = state
        best = cost
        for dy, dx in offsets:
            nc = _shifted(cost, dy, dx, jnp.float32(_INF))
            best = jnp.minimum(best, jnp.maximum(nc, img))
        new = jnp.where(seeded, cost0, jnp.where(m, best, jnp.float32(_INF)))
        return new, jnp.any(new != cost), i + 1

    cost, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_iters), cost_body,
        (cost0, jnp.bool_(True), 0),
    )

    at_level = img == cost  # pixel sits at its flood level
    neg_inf = jnp.float32(-_INF)
    lab_i = jnp.where(seeded, lab0, _BIG)
    d_i = jnp.where(seeded, 0, _BIG)
    dr_i = jnp.where(seeded, 0, _BIG)
    e_i = jnp.where(seeded, neg_inf, jnp.float32(_INF))

    H, W = img.shape
    lin = (
        jax.lax.broadcasted_iota(jnp.int32, img.shape, 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, img.shape, 1)
    )
    if variant == "basin":
        from particle_col_image_segmentation_tpu.ops.ccl import (
            connected_components,
        )

        below = m & ~seeded & ~at_level & (cost < _INF)
        comp = connected_components(
            below.astype(jnp.int32), background=0, connectivity=4
        )
        seg = jnp.where(below, comp, lin)
    else:
        seg = lin  # unused

    def candidates(lab, dist, dreal, eimg, dy, dx):
        nc = _shifted(cost, dy, dx, jnp.float32(_INF))
        nim = _shifted(img, dy, dx, jnp.float32(_INF))
        nl = _shifted(lab, dy, dx, _BIG)
        nd = _shifted(dist, dy, dx, _BIG)
        ndr = _shifted(dreal, dy, dx, _BIG)
        ne = _shifted(eimg, dy, dx, jnp.float32(_INF))
        valid = (jnp.maximum(nc, img) == cost) & (nl != _BIG)
        reset = nc < cost
        if variant == "basin":
            nseg = _shifted(seg, dy, dx, jnp.int32(-1))
            valid = valid & (nseg != seg)  # external edges only
            inc = at_level.astype(jnp.int32)
        elif variant == "base":
            inc = 1
        elif variant == "downfree":
            # free only on strictly-downhill claims: img[p] < img[n].  The
            # potential (cost, d, -img) strictly increases per edge, so the
            # justification graph stays acyclic (no phantom fixpoints).
            inc = (img >= nim).astype(jnp.int32)
        else:
            inc = at_level.astype(jnp.int32)
        cd = jnp.where(
            valid,
            jnp.where(reset, 0, jnp.where(nd < _BIG, nd + inc, _BIG)),
            _BIG,
        )
        cdr = jnp.where(
            valid,
            jnp.where(reset, 0, jnp.where(ndr < _BIG, ndr + 1, _BIG)),
            _BIG,
        )
        ce = jnp.where(valid, jnp.where(reset, nim, ne), jnp.float32(_INF))
        cs = jnp.where(valid, nim, jnp.float32(_INF))
        cl = jnp.where(valid, nl, _BIG)
        return cd, ce, cs, cdr, cl

    def fold(best, cand):
        bd, be, bs, bdr, bl = best
        cd, ce, cs, cdr, cl = cand
        if variant == "tunnel_dreal":
            bkey = (bd, be, bs, bdr, bl)
            ckey = (cd, ce, cs, cdr, cl)
        else:
            bkey = (bd, be, bs, bl)
            ckey = (cd, ce, cs, cl)
        take = jnp.zeros(bd.shape, bool)
        eq = jnp.ones(bd.shape, bool)
        for bk, ck in zip(bkey, ckey):
            take = take | (eq & (ck < bk))
            eq = eq & (ck == bk)
        return tuple(jnp.where(take, c, b) for b, c in zip(best, cand))

    def seg_lex_min(bd, be, bs, bl):
        """Per-segment lexicographic min of (d, e, s, lab), broadcast back."""
        n = H * W
        s = seg.reshape(-1)
        d = bd.reshape(-1)
        e = be.reshape(-1)
        c = bs.reshape(-1)
        l = bl.reshape(-1)
        dm = jax.ops.segment_min(d, s, num_segments=n)[s]
        t = d == dm
        em = jax.ops.segment_min(jnp.where(t, e, _INF), s, num_segments=n)[s]
        t = t & (e == em)
        cm = jax.ops.segment_min(jnp.where(t, c, _INF), s, num_segments=n)[s]
        t = t & (c == cm)
        lm = jax.ops.segment_min(jnp.where(t, l, _BIG), s, num_segments=n)[s]
        return (
            dm.reshape(img.shape),
            em.reshape(img.shape),
            lm.reshape(img.shape),
        )

    def lab_body(state):
        lab, dist, dreal, eimg, _, i = state
        best = (
            jnp.full(img.shape, _BIG, jnp.int32),
            jnp.full(img.shape, _INF, jnp.float32),
            jnp.full(img.shape, _INF, jnp.float32),
            jnp.full(img.shape, _BIG, jnp.int32),
            jnp.full(img.shape, _BIG, jnp.int32),
        )
        for dy, dx in offsets:
            cd, ce, cs, cdr, cl = candidates(lab, dist, dreal, eimg, dy, dx)
            best = fold(best, (cd, ce, cs, cdr, cl))
        bd, be, bs_, bdr, bl = best
        if variant == "basin":
            bd, be, bl = seg_lex_min(bd, be, bs_, bl)
            # dreal is not part of the basin key and zero-inc ties would
            # let it ratchet forever — pin it out of the state evolution
            bdr = jnp.zeros(img.shape, jnp.int32)
        new_l = jnp.where(seeded, lab0, jnp.where(m, bl, _BIG))
        new_d = jnp.where(seeded, 0, jnp.where(m, bd, _BIG))
        new_dr = jnp.where(seeded, 0, jnp.where(m, bdr, _BIG))
        new_e = jnp.where(seeded, neg_inf, jnp.where(m, be, jnp.float32(_INF)))
        ch = (
            jnp.any(new_l != lab) | jnp.any(new_d != dist)
            | jnp.any(new_dr != dreal) | jnp.any(new_e != eimg)
        )
        return new_l, new_d, new_dr, new_e, ch, i + 1

    lab, _, _, _, changed, iters = jax.lax.while_loop(
        lambda s: s[4] & (s[5] < max_iters), lab_body,
        (lab_i, d_i, dr_i, e_i, jnp.bool_(True), 0),
    )
    reached = m & (cost < _INF) & (lab != _BIG)
    return jnp.where(reached, lab, 0), ~changed, iters


def iou_for(q, markers, binary, variant):
    lab, conv, iters = ws_variant(
        jnp.asarray(q), jnp.asarray(markers), jnp.asarray(binary), variant
    )
    orc = ond.watershed(q, markers, mask=binary)
    iou = float(boundary_iou(np.asarray(lab), orc))
    if not bool(conv):
        return -iou, int(iters)  # negative marks an UNCONVERGED run
    return iou, int(iters)


def dense_case(prob, k):
    q = quantize(prob, k)
    binary = q < 0.5
    dist = ndi.distance_transform_edt(binary)
    markers = ond.label(ond.local_maxima(dist).astype(np.uint8))
    return q, markers, binary


def sparse_case(prob, k, seed=2):
    q = quantize(prob, k)
    rng = np.random.default_rng(seed)
    markers = np.zeros(prob.shape, np.int32)
    n = prob.shape[0]
    pts = sorted({(int(y), int(x)) for y, x in rng.integers(0, n, (20, 2))})
    for i, (cy, cx) in enumerate(pts):
        markers[cy, cx] = i + 1
    return q, markers, np.ones(prob.shape, bool)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    variants = sys.argv[2].split(",") if len(sys.argv) > 2 else [
        "base", "tunnel", "tunnel_dreal"
    ]
    for name, prob in fixtures(n):
        for regime, maker in (("dense", dense_case), ("sparse", sparse_case)):
            for k in (8, 32, 256, 0):
                q, markers, binary = maker(prob, k)
                if not binary.any():
                    continue
                row = {"fixture": name, "regime": regime, "k": k or "inf"}
                for v in variants:
                    iou, iters = iou_for(q, markers, binary, v)
                    row[v] = round(iou, 4)
                    row[v + "_it"] = iters
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
