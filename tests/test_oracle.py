"""Oracle self-consistency tests: the skimage-equivalent primitives must
satisfy their defining properties (checked against scipy where possible)."""

import numpy as np
import pytest
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu.oracle import reference_pipeline as refpipe

from fixtures import random_binary, random_class_plane, synthetic_label_plane


class TestDisk:
    def test_matches_formula(self):
        for r in (1, 2, 5, 20):
            d = ond.disk(r)
            yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
            np.testing.assert_array_equal(d, (yy**2 + xx**2 <= r**2).astype(np.uint8))


class TestLabel:
    def test_equal_value_connectivity(self):
        img = np.array(
            [
                [1, 1, 2, 2],
                [1, 0, 0, 2],
                [3, 3, 0, 2],
                [3, 3, 2, 2],
            ]
        )
        lab, n = ond.label(img, return_num=True)
        # components: {1s}, {2s — all 8-connected along the right edge}, {3s}
        assert n == 3
        for i in range(1, n + 1):
            vals = np.unique(img[lab == i])
            assert len(vals) == 1
        # background zeros unlabeled
        assert np.all(lab[img == 0] == 0)

    def test_diagonal_connectivity(self):
        img = np.array([[1, 0], [0, 1]])
        lab = ond.label(img)
        assert lab[0, 0] == lab[1, 1] == 1  # 8-connectivity joins diagonals
        lab4 = ond.label(img, connectivity=1)
        assert lab4[0, 0] != lab4[1, 1]

    def test_raster_order_ids(self):
        img = np.array(
            [
                [0, 0, 5, 0],
                [2, 0, 0, 0],
                [0, 0, 0, 7],
            ]
        )
        lab = ond.label(img)
        assert lab[0, 2] == 1  # first in raster order
        assert lab[1, 0] == 2
        assert lab[2, 3] == 3

    def test_component_count_matches_scipy_per_value(self):
        img = random_class_plane(seed=3)
        lab, n = ond.label(img, return_num=True)
        total = 0
        for v in np.unique(img):
            _, nv = ndi.label(img == v, structure=np.ones((3, 3)))
            total += nv
        assert n == total


class TestRegionprops:
    def test_props_match_manual(self):
        img = synthetic_label_plane(seed=1)
        lab = ond.label(img)
        regions = ond.regionprops(lab)
        assert [r.label for r in regions] == list(range(1, len(regions) + 1))
        for r in regions[:: max(1, len(regions) // 7)]:
            ys, xs = np.nonzero(lab == r.label)
            assert r.area == len(ys)
            np.testing.assert_allclose(r.centroid, (ys.mean(), xs.mean()))
            assert r.bbox == (ys.min(), xs.min(), ys.max() + 1, xs.max() + 1)
            # coords raster-ordered
            np.testing.assert_array_equal(
                r.coords, np.stack([ys, xs], axis=1)
            )

    def test_skips_absent_label_ids(self):
        """Regression: non-contiguous ids once crashed (skimage skips them)."""
        lab = np.array([[1, 0], [0, 3]])
        regions = ond.regionprops(lab)
        assert [r.label for r in regions] == [1, 3]
        assert [r.area for r in regions] == [1, 1]

    def test_dict_access_and_adhoc_attr(self):
        img = synthetic_label_plane(seed=2)
        regions = ond.regionprops(ond.label(img))
        r = regions[0]
        assert r["area"] == r.area
        r.cells = 3
        assert r.cells == 3


class TestDilationEDT:
    @pytest.mark.parametrize("r", [1, 2, 5, 20])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_disk_dilation_equals_edt_threshold(self, r, seed):
        """dilate(X, disk(r)) == EDT(~X) <= r — the identity the device kernels use."""
        x = random_binary((96, 96), p=0.05, seed=seed)
        dil = ond.binary_dilation(x, ond.disk(r))
        edt = ndi.distance_transform_edt(~x)
        np.testing.assert_array_equal(dil, edt <= r)

    def test_matches_scipy(self):
        x = random_binary((64, 64), p=0.2, seed=5)
        for r in (1, 3):
            np.testing.assert_array_equal(
                ond.binary_dilation(x, ond.disk(r)),
                ndi.binary_dilation(x, structure=ond.disk(r) > 0),
            )


class TestLocalMaxima:
    def test_simple_peak(self):
        img = np.zeros((7, 7))
        img[3, 3] = 2.0
        img[1, 1] = 1.0
        lm = ond.local_maxima(img)
        assert lm[3, 3] and lm[1, 1]
        # the flat zero background touches higher pixels → not maxima there
        assert not lm[0, 6]

    def test_plateau(self):
        img = np.zeros((5, 8))
        img[2, 2:4] = 1.0  # plateau of two pixels, isolated → max
        img[2, 6] = 1.0
        img[1, 6] = 2.0  # plateau pixel adjacent to higher → not max
        lm = ond.local_maxima(img)
        assert lm[2, 2] and lm[2, 3]
        assert not lm[2, 6]
        assert lm[1, 6]

    def test_constant_image(self):
        img = np.ones((4, 4))
        assert ond.local_maxima(img).all()


class TestWatershed:
    def test_two_basin_split(self):
        # relief: two pits separated by a ridge in the middle column
        img = np.zeros((5, 9))
        img[:, 4] = 1.0
        markers = np.zeros((5, 9), dtype=int)
        markers[2, 1] = 1
        markers[2, 7] = 2
        out = ond.watershed(img, markers)
        assert (out[:, :4] == 1).all()
        assert (out[:, 5:] == 2).all()

    def test_mask_respected_and_markers_kept(self):
        img = random_binary((32, 32), p=0.4, seed=7).astype(float)
        mask = np.zeros((32, 32), bool)
        mask[4:28, 4:28] = True
        markers = np.zeros((32, 32), int)
        markers[10, 10] = 1
        markers[20, 20] = 2
        out = ond.watershed(img, markers, mask=mask)
        assert (out[~mask] == 0).all()
        assert out[10, 10] == 1 and out[20, 20] == 2
        # everything reachable in mask is labeled
        assert (out[mask] > 0).all()


class TestGauss:
    def test_normalized_and_matches_direct_conv(self):
        rng = np.random.default_rng(0)
        img = rng.random((16, 16))
        out = ond.imgaussfilt(img, 1.0)
        half = 2  # ceil(2*1.0)
        x = np.arange(-half, half + 1)
        k = np.exp(-(x**2) / 2.0)
        k /= k.sum()
        k2 = np.outer(k, k)
        expected = ndi.convolve(img, k2, mode="nearest")
        np.testing.assert_allclose(out, expected, atol=1e-12)


class TestReferencePipeline:
    def test_single_strain_end_to_end(self):
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = synthetic_label_plane(seed=4, cell_types=cell_types)
        den = refpipe.denoise(img)
        pos, clusters, particle_area, merged = refpipe.get_cell_positions_and_areas(
            den, cell_types, merged=True
        )
        assert particle_area > 0
        assert "3D05" in pos
        assert all(20 <= r.area < 200 for r in pos["3D05"])
        assert all(r.area >= 200 for r in clusters["3D05"])
        for c in clusters["3D05"]:
            assert isinstance(c.cells, int)
        assert set(merged) == {"3D05", "combined"}
        # merged groups conserve area
        for rec in merged["3D05"]:
            assert rec["area"] == sum(r.area for r in rec["regions"])
        counts, dens, ratios = refpipe.get_cell_counts_and_densities(
            pos, clusters, particle_area
        )
        assert counts["3D05"] >= len(pos["3D05"])
        assert dens["3D05"] > 0 and ratios["3D05"] > 0

    def test_particle_fill_monotone(self):
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = synthetic_label_plane(seed=5, cell_types=cell_types)
        _, _, particle_area, _ = refpipe.get_cell_positions_and_areas(img, cell_types)
        updated, new_area = refpipe.recreate_particle_area(
            img, cell_types, particle_area
        )
        assert new_area >= particle_area
        # filled pixels became particle
        assert np.sum(updated == 2) >= np.sum(img == 2)

    def test_cluster_without_singles_fixed_vs_strict(self):
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = np.full((64, 64), 3, np.uint8)
        from fixtures import paint_disk

        paint_disk(img, 20, 20, 10, 1)  # one big cluster, no singles
        paint_disk(img, 50, 50, 6, 2)
        pos, clusters, _, _ = refpipe.get_cell_positions_and_areas(img, cell_types)
        assert pos["3D05"] == []
        assert clusters["3D05"][0].cells == 0  # deliberate fix (SURVEY §2.6)
        with pytest.raises(Exception):
            refpipe.get_cell_positions_and_areas(
                img, cell_types, cfg=AnalysisConfig(strict_reference_errors=True)
            )

    def test_dapi_dedup(self):
        from fixtures import paint_disk

        dapi = np.full((64, 64), 3, np.uint8)
        other = np.full((64, 64), 3, np.uint8)
        paint_disk(dapi, 10, 10, 4, 1)  # overlaps other cell → removed
        paint_disk(other, 10, 10, 4, 1)
        paint_disk(dapi, 40, 40, 4, 1)  # no overlap → kept
        out = refpipe.combine_cell_positions_and_clusters(dapi, other)
        assert (out[dapi == 1][: np.sum(dapi == 1)] != 0).all()
        assert np.all(out[8:13, 8:13][dapi[8:13, 8:13] == 1] == 2)
        assert np.all(out[38:43, 38:43][dapi[38:43, 38:43] == 1] == 1)
