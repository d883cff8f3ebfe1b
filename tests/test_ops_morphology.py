"""Parity tests: EDT, morphology, local maxima, watershed vs oracle/scipy."""

import numpy as np
import pytest
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import (
    boundary_mask,
    dilate_disk,
    edt,
    edt_sq,
    fill_holes,
    gaussian_blur,
    local_maxima,
    watershed,
)
from particle_col_image_segmentation_tpu.oracle import ndimage as ond

from fixtures import random_binary, synthetic_label_plane


class TestEDT:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("cap", [2, 5, 20])
    def test_exact_within_cap(self, seed, cap):
        m = random_binary((80, 80), p=0.04, seed=seed)
        ours = np.asarray(edt_sq(jnp.asarray(m), cap=cap))
        ref = ndi.distance_transform_edt(~m) ** 2
        within = ref <= cap * cap
        np.testing.assert_allclose(ours[within], np.round(ref[within]))
        assert (ours[~within] > cap * cap).all()

    def test_empty_feature_saturates(self):
        m = np.zeros((16, 16), bool)
        ours = np.asarray(edt_sq(jnp.asarray(m), cap=3))
        assert (ours == 16).all()  # (cap+1)²

    def test_float_edt(self):
        m = random_binary((48, 48), p=0.1, seed=2)
        ours = np.asarray(edt(jnp.asarray(m), cap=10))
        ref = ndi.distance_transform_edt(~m)
        sel = ref <= 10
        np.testing.assert_allclose(ours[sel], ref[sel], rtol=1e-6)

    @pytest.mark.parametrize("seed,p", [(0, 0.02), (3, 0.001), (4, 0.3)])
    def test_exact_uncapped(self, seed, p):
        """Regression: refine's marker seeding needs scipy-exact EDT at ANY
        depth — a saturating cap merged deep-region maxima into one marker."""
        from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact

        m = random_binary((64, 96), p=p, seed=seed)
        if not m.any():
            m[3, 5] = True
        ours = np.asarray(edt_sq_exact(jnp.asarray(m)))
        ref = ndi.distance_transform_edt(~m) ** 2
        np.testing.assert_allclose(ours, np.round(ref))

    @pytest.mark.parametrize(
        "shape,feat",
        [
            ((256, 32), [(1, 7)]),  # distances ≫ W+1: featureless-row sentinel
            ((256, 32), [(250, 0), (4, 31)]),
            ((128, 128), [(0, 0)]),  # corner feature, many featureless rows
            ((300, 16), [(150, 8)]),
        ],
    )
    def test_exact_tall_narrow_distant_feature(self, shape, feat):
        """Regression (ADVICE r1): rows with no feature pixel must contribute
        +inf to the min-plus, not (W+1)² — tall-narrow planes with distant
        features previously got far-too-small distances."""
        from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact

        m = np.zeros(shape, bool)
        for r, c in feat:
            m[r, c] = True
        ours = np.asarray(edt_sq_exact(jnp.asarray(m)))
        ref = ndi.distance_transform_edt(~m) ** 2
        np.testing.assert_allclose(ours, np.round(ref))


class TestCappedEDT:
    """edt_sq against scipy on batches, degenerate densities and caps past
    the small-cap tap path: exact up to the cap, saturated beyond it."""

    @staticmethod
    def _check(m, cap, got):
        planes = m.reshape((-1,) + m.shape[-2:])
        got = got.reshape(planes.shape)
        c1 = (cap + 1) ** 2
        for f, g in zip(planes, got):
            ref = (
                ndi.distance_transform_edt(~f) ** 2 if f.any()
                else np.full(f.shape, np.inf)
            )
            np.testing.assert_array_equal(g, np.minimum(np.round(ref), c1))

    @pytest.mark.parametrize("seed,shape,cap", [
        (0, (64, 128), 32),
        (1, (2, 64, 128), 20),
        (2, (128, 256), 9),
        (3, (3, 48, 128), 32),
    ])
    def test_matches_scipy(self, seed, shape, cap):
        rng = np.random.default_rng(seed)
        m = rng.random(shape) < 0.02
        self._check(m, cap, np.asarray(edt_sq(jnp.asarray(m), cap=cap)))

    @pytest.mark.parametrize("dens", [0.0, 1.0, 0.5])
    def test_degenerate_densities(self, dens):
        rng = np.random.default_rng(7)
        m = rng.random((64, 128)) < dens
        self._check(m, 20, np.asarray(edt_sq(jnp.asarray(m), cap=20)))

    def test_plane_isolation(self):
        """A feature-dense plane must not leak distances into its batch
        neighbors."""
        m = np.zeros((2, 64, 128), bool)
        m[0] = True  # plane 0 all-feature; plane 1 empty
        b = np.asarray(edt_sq(jnp.asarray(m), cap=20))
        assert (b[0] == 0).all()
        assert (b[1] == 21 * 21).all()  # saturated, no leak from plane 0

    def test_large_cap_matches_exact(self):
        """A cap beyond the plane's deepest distance gives the exact
        transform (the certified-exact EDT's fast-path identity)."""
        from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact

        m = random_binary((80, 80), p=0.04, seed=5)
        a = np.asarray(edt_sq(jnp.asarray(m), cap=64))
        b = np.asarray(edt_sq_exact(jnp.asarray(m)))
        assert b.max() <= 64 * 64
        np.testing.assert_array_equal(a, b)


class TestCertifiedExactEDT:
    """edt_sq_exact_auto must be bit-identical to edt_sq_exact on BOTH sides
    of its runtime certificate: shallow planes (capped fast path taken) and
    deep planes (lax.cond fallback to the full min-plus)."""

    @pytest.mark.parametrize("probe_cap", [4, 32])
    def test_shallow_takes_fast_path_exactly(self, probe_cap):
        from particle_col_image_segmentation_tpu.ops.edt import (
            edt_sq_exact,
            edt_sq_exact_auto,
        )

        m = random_binary((64, 96), p=0.3, seed=11)  # dense → shallow
        a = np.asarray(edt_sq_exact(jnp.asarray(m)))
        b = np.asarray(edt_sq_exact_auto(jnp.asarray(m), probe_cap=probe_cap))
        np.testing.assert_array_equal(a, b)

    def test_deep_triggers_fallback_exactly(self):
        from particle_col_image_segmentation_tpu.ops.edt import (
            edt_sq_exact,
            edt_sq_exact_auto,
        )

        m = np.zeros((64, 96), bool)
        m[0, 0] = True  # distances up to ~115 ≫ probe_cap
        a = np.asarray(edt_sq_exact(jnp.asarray(m)))
        b = np.asarray(edt_sq_exact_auto(jnp.asarray(m), probe_cap=32))
        np.testing.assert_array_equal(a, b)
        ref = ndi.distance_transform_edt(~m) ** 2
        np.testing.assert_allclose(b, np.round(ref))

    def test_batched_mixed_depth(self):
        """One shallow plane + one deep plane in a stack: the scalar
        certificate covers the whole batch, so the deep plane must force
        the exact path for both (bit-identical everywhere)."""
        from particle_col_image_segmentation_tpu.ops.edt import (
            edt_sq_exact,
            edt_sq_exact_auto,
        )

        shallow = random_binary((64, 96), p=0.3, seed=12)
        deep = np.zeros((64, 96), bool)
        deep[0, 0] = True
        mb = np.stack([shallow, deep])
        a = np.asarray(edt_sq_exact(jnp.asarray(mb)))
        b = np.asarray(edt_sq_exact_auto(jnp.asarray(mb), probe_cap=32))
        np.testing.assert_array_equal(a, b)


class TestDilation:
    @pytest.mark.parametrize("r", [1, 2, 5, 20])
    def test_matches_oracle_disk(self, r):
        m = random_binary((96, 96), p=0.03, seed=3)
        ours = np.asarray(dilate_disk(jnp.asarray(m), r))
        ref = ond.binary_dilation(m, ond.disk(r))
        np.testing.assert_array_equal(ours, ref)

    def test_batched(self):
        m = np.stack([random_binary((48, 48), p=0.05, seed=s) for s in range(2)])
        ours = np.asarray(dilate_disk(jnp.asarray(m), 4))
        for i in range(2):
            np.testing.assert_array_equal(ours[i], ond.binary_dilation(m[i], ond.disk(4)))


class TestFillHoles:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_scipy(self, seed):
        # blobs with holes: dilated random points minus interior dots
        m = random_binary((72, 72), p=0.02, seed=seed)
        m = ond.binary_dilation(m, ond.disk(6))
        rng = np.random.default_rng(seed + 100)
        holes = rng.random(m.shape) < 0.1
        m = m & ~holes
        ours = np.asarray(fill_holes(jnp.asarray(m)))
        ref = ndi.binary_fill_holes(m)
        np.testing.assert_array_equal(ours, ref)

    def test_ring(self):
        m = np.zeros((32, 32), bool)
        m[8:24, 8:24] = True
        m[12:20, 12:20] = False
        ours = np.asarray(fill_holes(jnp.asarray(m)))
        expected = np.zeros((32, 32), bool)
        expected[8:24, 8:24] = True
        np.testing.assert_array_equal(ours, expected)


class TestLocalMaxima:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_oracle_on_edt(self, seed):
        # the refine_boundaries use case: maxima of a distance transform
        m = random_binary((64, 64), p=0.03, seed=seed)
        m = ond.binary_dilation(m, ond.disk(5))
        dist = ndi.distance_transform_edt(m)
        ours = np.asarray(local_maxima(jnp.asarray(dist)))
        ref = ond.local_maxima(dist)
        np.testing.assert_array_equal(ours, ref)

    def test_plateau_cases(self):
        img = np.zeros((5, 8))
        img[2, 2:4] = 1.0
        img[2, 6] = 1.0
        img[1, 6] = 2.0
        ours = np.asarray(local_maxima(jnp.asarray(img)))
        ref = ond.local_maxima(img)
        np.testing.assert_array_equal(ours, ref)

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_batched_integer_edt_matches_oracle(self, seed, connectivity):
        """Refine's input: a batch of integer squared-EDT planes with
        plateaus; every plane must match the oracle, flagged converged."""
        planes = []
        for b in range(2):
            m = random_binary((128, 128), p=0.03, seed=seed + 7 * b)
            m = ond.binary_dilation(m, ond.disk(5))
            planes.append(
                np.round(ndi.distance_transform_edt(m) ** 2).astype(np.int32)
            )
        dsq = jnp.asarray(np.stack(planes))
        got, conv = local_maxima(dsq, connectivity=connectivity, with_flag=True)
        assert bool(np.asarray(conv).all())
        for b in range(2):
            np.testing.assert_array_equal(
                np.asarray(got)[b],
                ond.local_maxima(
                    planes[b].astype(np.float64),
                    connectivity=connectivity,
                ),
            )


class TestBoundaryMask:
    def test_matches_oracle(self):
        m = random_binary((48, 48), p=0.02, seed=7)
        m = ond.binary_dilation(m, ond.disk(5))
        ours = np.asarray(boundary_mask(jnp.asarray(m)))
        ref_pts = ond.bwboundaries_pixels(m)
        ref = np.zeros_like(m)
        ref[ref_pts[:, 0], ref_pts[:, 1]] = True
        np.testing.assert_array_equal(ours, ref)


class TestGaussianBlur:
    def test_matches_oracle(self):
        rng = np.random.default_rng(0)
        img = rng.random((32, 32))
        for sigma in (1.0, 1.5):
            ours = np.asarray(gaussian_blur(jnp.asarray(img), sigma))
            ref = ond.imgaussfilt(img, sigma)
            np.testing.assert_allclose(ours, ref, atol=1e-5)


def _iou(a, b):
    return np.sum(a & b) / max(1, np.sum(a | b))


class TestWatershedBatched:
    """A [B, H, W] batch floods in one fixpoint loop; every plane must be
    bit-identical to its own single-plane run, including the
    schedule-divergence stress case (random noise relief)."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_relief_batch_matches_single(self, seed):
        rng = np.random.default_rng(seed)
        img = rng.random((2, 64, 64)).astype(np.float32)
        mk = np.zeros((2, 64, 64), np.int32)
        mk[:, 10, 10] = 2
        mk[:, 50, 50] = 1
        mk[:, 30, 60] = 3
        got, conv = watershed(jnp.asarray(img), jnp.asarray(mk),
                              with_flag=True)
        assert bool(np.asarray(conv).all())
        for b in range(2):
            ref = np.asarray(watershed(jnp.asarray(img[b]), jnp.asarray(mk[b])))
            np.testing.assert_array_equal(np.asarray(got)[b], ref)
            assert (ref > 0).all()

    def test_masked_structured_matches_oracle(self):
        from particle_col_image_segmentation_tpu.utils.metrics import (
            boundary_iou,
        )

        m = np.zeros((96, 96), bool)
        yy, xx = np.mgrid[:96, :96]
        for cy, cx in ((48, 30), (48, 66)):
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= 300
        relief = (1.0 - ndi.distance_transform_edt(m) / 16.0).clip(0, 1).astype(np.float32)
        mk = np.zeros((96, 96), np.int32)
        mk[48, 30] = 1
        mk[48, 66] = 2
        got = np.asarray(
            watershed(jnp.asarray(relief), jnp.asarray(mk), jnp.asarray(m))
        )
        assert (got[~m] == 0).all() and (got[m] > 0).all()
        orc = ond.watershed(relief, mk, mask=m)
        assert boundary_iou(got, orc) >= 0.99

    def test_batched_planes_stay_isolated(self):
        """A plane whose basin touches the plane edge must not flood into
        its batch neighbor, and a masked strip at the edge stays 0."""
        rng = np.random.default_rng(7)
        planes, marks, masks = [], [], []
        for b in range(3):
            img = rng.random((64, 128)).astype(np.float32)
            # plane 1: a flat low-cost corridor along the bottom edge —
            # maximally tempting to leak into plane 2's top rows
            if b == 1:
                img[-12:, :] = 0.01
            mk = np.zeros((64, 128), np.int32)
            mk[8, 8 + 11 * b] = 1 + b
            mk[55, 100 - 9 * b] = 4 + b
            m = np.ones((64, 128), bool)
            if b == 2:
                m[:4, :] = False  # masked-out strip at the plane edge
            planes.append(img)
            marks.append(mk)
            masks.append(m)
        got, conv = watershed(
            jnp.asarray(np.stack(planes)), jnp.asarray(np.stack(marks)),
            jnp.asarray(np.stack(masks)), with_flag=True,
        )
        assert conv.shape == (3,) and bool(np.asarray(conv).all())
        for b in range(3):
            single = np.asarray(
                watershed(
                    jnp.asarray(planes[b]), jnp.asarray(marks[b]),
                    jnp.asarray(masks[b]),
                )
            )
            np.testing.assert_array_equal(np.asarray(got)[b], single)
            assert set(np.unique(single[masks[b]])) == {1 + b, 4 + b}
        assert (np.asarray(got)[2][:4] == 0).all()


class TestWatershed:
    def test_two_basin_exact(self):
        img = np.zeros((5, 9), np.float32)
        img[:, 4] = 1.0
        markers = np.zeros((5, 9), np.int32)
        markers[2, 1] = 1
        markers[2, 7] = 2
        out = np.asarray(watershed(jnp.asarray(img), jnp.asarray(markers)))
        ref = ond.watershed(img, markers)
        assert (out[:, :4] == 1).all() and (out[:, 5:] == 2).all()
        # per-basin IoU vs oracle
        for lab in (1, 2):
            assert _iou(out == lab, ref == lab) > 0.85

    def test_touching_cells_refine_flow(self):
        # two touching discs, boundary prob relief = inverted EDT
        m = np.zeros((48, 64), bool)
        yy, xx = np.mgrid[:48, :64]
        m |= (yy - 24) ** 2 + (xx - 24) ** 2 <= 144
        m |= (yy - 24) ** 2 + (xx - 40) ** 2 <= 144
        dist = ndi.distance_transform_edt(m)
        relief = (-dist).astype(np.float32)
        markers = np.zeros(m.shape, np.int32)
        markers[24, 24] = 1
        markers[24, 40] = 2
        out = np.asarray(
            watershed(jnp.asarray(relief), jnp.asarray(markers), jnp.asarray(m))
        )
        ref = ond.watershed(relief, markers, mask=m)
        assert (np.asarray(out)[~m] == 0).all()
        assert (np.asarray(out)[m] > 0).all()
        for lab in (1, 2):
            assert _iou(out == lab, ref == lab) > 0.9

    def test_batched_matches_per_plane(self):
        """A [B,H,W] batch floods in one fixpoint loop; each plane must be
        bit-identical to its single-plane run (extra Jacobi steps after a
        plane converges are no-ops)."""
        rng = np.random.default_rng(7)
        B, H, W = 3, 40, 56
        imgs, marks, masks = [], [], []
        for b in range(B):
            m = np.zeros((H, W), bool)
            yy, xx = np.mgrid[:H, :W]
            for _ in range(3):
                cy, cx = rng.integers(8, H - 8), rng.integers(8, W - 8)
                m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= int(rng.integers(20, 90))
            dist = ndi.distance_transform_edt(m)
            relief = (-dist).astype(np.float32)
            mk = np.zeros((H, W), np.int32)
            for i in range(2):
                my, mx = rng.integers(0, H), rng.integers(0, W)
                if m[my, mx]:
                    mk[my, mx] = i + 1
            mk[H // 2, W // 2] = 3 if m[H // 2, W // 2] else 0
            imgs.append(relief); marks.append(mk); masks.append(m)
        bi, bm, bk = map(np.stack, (imgs, marks, masks))
        out_b, conv = watershed(
            jnp.asarray(bi), jnp.asarray(bm), jnp.asarray(bk), with_flag=True
        )
        assert np.asarray(conv).shape == (B,) and np.asarray(conv).all()
        for b in range(B):
            ref = watershed(
                jnp.asarray(imgs[b]), jnp.asarray(marks[b]),
                jnp.asarray(masks[b]),
            )
            np.testing.assert_array_equal(
                np.asarray(out_b)[b], np.asarray(ref)
            )

    def test_batched_flag_is_per_plane(self):
        """A starved iteration budget must blame only the plane that ran
        out, not the whole batch (the flags drive refine's error message)."""
        H, W = 8, 64
        # plane 0: open rectangle (Jacobi flood needs ~H+W steps); plane 1:
        # a serpentine corridor needing ~4·W steps — a budget between the
        # two converges plane 0 only
        easy = np.zeros((H, W), np.float32)
        snake = np.zeros((H, W), bool)
        snake[0, :] = True
        for r in range(1, H):
            snake[r, (W - 1) if r % 4 in (1, 2) else 0] = True
            if r % 4 == 3:
                snake[r, :] = True
        img = np.stack([easy, easy])
        marks = np.zeros((2, H, W), np.int32)
        marks[:, 0, 0] = 1
        masks = np.stack([np.ones((H, W), bool), snake])
        _, conv = watershed(
            jnp.asarray(img), jnp.asarray(marks), jnp.asarray(masks),
            max_iters=128, with_flag=True,
        )
        conv = np.asarray(conv)
        assert conv.shape == (2,)
        assert bool(conv[0]) and not bool(conv[1])

    @pytest.mark.parametrize("seed,n,thr", [(1, 256, 0.985), (2, 128, 0.99)])
    def test_priority_flood_iou_regression(self, seed, n, thr):
        """Regression (VERDICT r1 #4): the (level distance, entry img,
        claimer img, marker id) claim key must hold ≥0.985 boundary IoU vs
        the priority-flood oracle on touching-cell reliefs (the old
        (distance, id) key measured 0.974 on the seed-1 fixture)."""
        from particle_col_image_segmentation_tpu.utils.metrics import (
            boundary_iou,
        )

        rng = np.random.default_rng(seed)
        m = np.zeros((n, n), bool)
        yy, xx = np.mgrid[:n, :n]
        for _ in range(n // 21):
            cy, cx = rng.integers(25, n - 25, 2)
            r2 = int(rng.integers(80, 250))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
            m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
        dist = ndi.distance_transform_edt(m)
        prob = (1.0 - dist / max(1.0, dist.max())).astype(np.float32)
        binary = prob < 0.5
        odist = ndi.distance_transform_edt(binary)
        omark = ond.label(ond.local_maxima(odist).astype(np.uint8))
        ref = ond.watershed(prob, omark, mask=binary)
        out = np.asarray(
            watershed(jnp.asarray(prob), jnp.asarray(omark), jnp.asarray(binary))
        )
        assert boundary_iou(out, ref) >= thr

    def test_mask_and_marker_preservation(self):
        rng = np.random.default_rng(3)
        img = rng.random((40, 40)).astype(np.float32)
        mask = np.zeros((40, 40), bool)
        mask[4:36, 4:36] = True
        markers = np.zeros((40, 40), np.int32)
        markers[10, 10] = 3
        markers[30, 30] = 1
        out = np.asarray(watershed(jnp.asarray(img), jnp.asarray(markers), jnp.asarray(mask)))
        assert out[10, 10] == 3 and out[30, 30] == 1
        assert (out[~mask] == 0).all()
        assert (out[mask] > 0).all()


class TestOpenCloseThreshold:
    def test_open_close(self):
        from particle_col_image_segmentation_tpu.ops.morphology import (
            close_disk,
            dilate_disk,
            erode_disk,
            open_disk,
        )

        rng = np.random.default_rng(0)
        m = np.zeros((64, 64), bool)
        yy, xx = np.mgrid[:64, :64]
        m |= (yy - 20) ** 2 + (xx - 20) ** 2 <= 100
        m[40, 40] = True  # single-pixel speck
        m[(yy - 45) ** 2 + (xx - 15) ** 2 <= 64] = True
        m[45, 12:19] = False  # thin gap
        got_open = np.asarray(open_disk(jnp.asarray(m), 2))
        ref_open = np.asarray(
            dilate_disk(erode_disk(jnp.asarray(m), 2), 2)
        )
        np.testing.assert_array_equal(got_open, ref_open)
        assert not got_open[40, 40]  # speck removed
        got_close = np.asarray(close_disk(jnp.asarray(m), 2))
        assert got_close[45, 15]  # gap filled
        assert got_close[m].all()  # closing is extensive
        del rng

    def test_otsu_matches_numpy_oracle(self):
        from particle_col_image_segmentation_tpu.ops.threshold import (
            otsu_threshold,
        )

        rng = np.random.default_rng(1)
        img = np.concatenate(
            [rng.normal(80, 10, 3000), rng.normal(180, 12, 2000)]
        ).reshape(50, 100).astype(np.float32)

        def oracle_otsu(x, bins=256):
            counts, edges = np.histogram(x, bins=bins)
            centers = (edges[:-1] + edges[1:]) / 2
            w0 = np.cumsum(counts).astype(float)
            w1 = w0[-1] - w0
            m = np.cumsum(counts * centers)
            mu0 = m / np.maximum(w0, 1e-12)
            mu1 = (m[-1] - m) / np.maximum(w1, 1e-12)
            var_b = np.where((w0 > 0) & (w1 > 0), w0 * w1 * (mu0 - mu1) ** 2, -1)
            return centers[np.argmax(var_b)]

        got = float(otsu_threshold(jnp.asarray(img)))
        ref = oracle_otsu(img)
        # binning conventions differ by half a bin; same class split matters
        assert abs(got - ref) < (img.max() - img.min()) / 256 * 2
        assert 100 < got < 160  # separates the two modes

    def test_otsu_batch_matches_single(self):
        """otsu_threshold_batch (vmapped histogram scatter) must be
        bit-identical to per-plane otsu_threshold — same bin indices,
        counts, and reduction."""
        from particle_col_image_segmentation_tpu.ops.threshold import (
            otsu_threshold,
            otsu_threshold_batch,
        )

        rng = np.random.default_rng(4)
        imgs = rng.normal(900.0, 200.0, (5, 64, 128)).astype(np.float32)
        imgs[1] = 3.0  # constant plane (degenerate span)
        imgs[2, :32] += 4000.0
        tb = np.asarray(otsu_threshold_batch(jnp.asarray(imgs)))
        ts = np.asarray(
            jnp.stack([otsu_threshold(jnp.asarray(p)) for p in imgs])
        )
        np.testing.assert_array_equal(tb, ts)

    def test_threshold_and_count(self):
        from particle_col_image_segmentation_tpu.ops.threshold import (
            threshold_and_count,
        )

        img = np.full((64, 64), 100.0, np.float32)
        yy, xx = np.mgrid[:64, :64]
        for cy, cx in [(16, 16), (16, 48), (48, 16), (48, 48)]:
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 36] = 900.0
        mask, seg, count, num = threshold_and_count(jnp.asarray(img), max_regions=64)
        assert int(num) == int(count) or int(num) >= int(count)
        assert int(count) == 4
        assert np.array_equal(np.asarray(mask), img > 500)

    def test_threshold_and_count_batch_matches_single(self):
        """The batched band-sweep pipeline (one launch per stack) must give
        the same per-plane masks and counts as the single-plane graph."""
        from particle_col_image_segmentation_tpu.ops.threshold import (
            threshold_and_count,
            threshold_and_count_batch,
        )

        rng = np.random.default_rng(4)
        yy, xx = np.mgrid[:64, :64]
        planes = []
        for b in range(3):
            img = (rng.random((64, 64)) * 300).astype(np.float32)
            for _ in range(3 + b):
                cy, cx = rng.integers(8, 56, 2)
                img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 30] = 5000.0
            planes.append(img)
        batch = jnp.asarray(np.stack(planes))
        bmask, bseg, bcount, bnum, btotal, conv = threshold_and_count_batch(
            batch, max_regions=255
        )
        assert bool(np.asarray(conv).all())
        # no overflow on these planes: true total component count (fg + bg
        # — background is labeled too under background=None) within capacity
        assert (np.asarray(btotal) <= 255).all()
        for b in range(3):
            m, s, c, n = threshold_and_count(batch[b], max_regions=255)
            np.testing.assert_array_equal(np.asarray(bmask[b]), np.asarray(m))
            assert int(bcount[b]) == int(c)
            assert int(bnum[b]) == int(n)
            # num_total counts fg and bg components, so it strictly exceeds
            # the fg-only count on these planes (bg is connected: ≥ 1 extra)
            assert int(btotal[b]) > int(bnum[b])

    def test_threshold_and_count_batch_overflow_detectable(self):
        """When a plane has more components than max_regions, num_total must
        report the TRUE count (> max_regions) so callers can detect the
        undercount — num_fg alone is capacity-clamped and cannot."""
        from particle_col_image_segmentation_tpu.ops.threshold import (
            threshold_and_count_batch,
        )

        # 8x8 grid of isolated bright dots = 64 fg components + 1 bg
        img = np.zeros((64, 64), np.float32)
        img[2::8, 2::8] = 5000.0
        img += np.random.default_rng(0).random((64, 64)).astype(np.float32)
        _, _, count, num_fg, num_total, conv = threshold_and_count_batch(
            jnp.asarray(img[None]), max_regions=16
        )
        assert bool(np.asarray(conv).all())
        assert int(num_total[0]) == 65  # true count, past capacity
        assert int(num_fg[0]) <= 16  # table-derived, capacity-clamped
        assert int(count[0]) <= 16


class TestParticleFill:
    def test_matches_scipy_criteria(self):
        """The fill stage reproduces the reference fill_particle_area
        criteria (tiff_analysis.py:982-1015) with scipy's EDT, strains in
        sequence: pixels absorbed for one strain grow the particle mask the
        next strain sees."""
        from particle_col_image_segmentation_tpu.config import AnalysisConfig
        from particle_col_image_segmentation_tpu.labels.analysis import (
            _stage_fill,
        )

        cfg = AnalysisConfig()
        for seed in (11, 12):
            img = synthetic_label_plane(seed=seed, shape=(64, 128)).astype(np.uint8)
            got, counts = _stage_fill(
                jnp.asarray(img), cfg=cfg, particle_val=2, strain_vals=(1, 3)
            )
            ref = img.copy()
            for k, sval in enumerate((1, 3)):
                d = ndi.distance_transform_edt(ref != 2)
                ov = (ref == sval) & (
                    (d < cfg.distance_threshold) | (d <= cfg.dilation_radius)
                )
                assert int(counts[k]) == int(ov.sum())
                ref = np.where(ov, 2, ref).astype(np.uint8)
            np.testing.assert_array_equal(np.asarray(got), ref)


class TestPairwise:
    """pdist2+min parity vs scipy.spatial (reference .m:259-268,301-304)."""

    def test_min_dist_to_set_matches_cdist(self):
        import jax.numpy as jnp
        from scipy.spatial.distance import cdist

        from particle_col_image_segmentation_tpu.ops.pairwise import (
            min_dist_to_set,
        )

        rng = np.random.default_rng(0)
        a = rng.uniform(0, 512, (37, 2))
        b = rng.uniform(0, 512, (211, 2))
        valid = rng.random(211) < 0.8
        got = np.asarray(
            min_dist_to_set(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                            block=64)
        )
        want = cdist(a, b[valid]).min(axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_large_coordinates_stay_exact(self):
        """Regression: the ‖a‖²+‖b‖²−2abᵀ matmul form is exposed to reduced
        matmul precision AND cancelled catastrophically in f32 for large-plane
        centroids (terms ~|a||b| > 2²⁴ round at ≥ 1 px²) — a 1 px NN
        distance at coordinate ~3000 came back off by whole pixels.  The
        difference form must be exact at every coordinate magnitude."""
        import jax.numpy as jnp

        from particle_col_image_segmentation_tpu.ops.pairwise import (
            min_dist_to_set,
            nearest_neighbor_dists,
        )

        # clustered pairs 1 px apart at large offsets (2048² plane corners)
        base = np.array(
            [[2001.0, 1500.0], [3000.0, 2999.0], [4095.0, 4095.0]]
        )
        pts = np.concatenate([base, base + [1.0, 0.0]])  # NN dist exactly 1
        got = np.asarray(
            nearest_neighbor_dists(jnp.asarray(pts), jnp.ones(6, bool),
                                   block=8)
        )
        np.testing.assert_array_equal(got, np.ones(6))
        got2 = np.asarray(
            min_dist_to_set(jnp.asarray(base), jnp.asarray(base + [1.0, 0.0]),
                            jnp.ones(3, bool), block=8)
        )
        np.testing.assert_array_equal(got2, np.ones(3))

    def test_min_dist_all_invalid_is_inf(self):
        import jax.numpy as jnp

        from particle_col_image_segmentation_tpu.ops.pairwise import (
            min_dist_to_set,
        )

        a = jnp.asarray(np.zeros((3, 2)))
        b = jnp.asarray(np.ones((5, 2)))
        got = np.asarray(min_dist_to_set(a, b, jnp.zeros(5, bool)))
        assert np.all(np.isinf(got))

    def test_nearest_neighbor_excludes_self(self):
        import jax.numpy as jnp
        from scipy.spatial.distance import cdist

        from particle_col_image_segmentation_tpu.ops.pairwise import (
            nearest_neighbor_dists,
        )

        rng = np.random.default_rng(1)
        pts = rng.uniform(0, 100, (23, 2))
        got = np.asarray(
            nearest_neighbor_dists(jnp.asarray(pts), jnp.ones(23, bool),
                                   block=8)
        )
        d = cdist(pts, pts)
        np.fill_diagonal(d, np.inf)
        np.testing.assert_allclose(got, d.min(axis=1), rtol=1e-4)
