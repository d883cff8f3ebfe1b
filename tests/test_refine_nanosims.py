"""Tests: watershed refinement pipeline and NanoSIMS ROI analysis."""

import numpy as np
import pytest
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu.config import NanoSIMSConfig, RefineConfig
from particle_col_image_segmentation_tpu.models import nanosims
from particle_col_image_segmentation_tpu.models.refine import (
    cross_strain_distances,
    refine_boundaries,
)


def _touching_cells_probability(H=96, W=128, centers=((48, 40), (48, 80)), r2=330):
    m = np.zeros((H, W), bool)
    yy, xx = np.mgrid[:H, :W]
    for cy, cx in centers:
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    prob = 1.0 - (dist / max(1.0, dist.max())).clip(0, 1)  # boundary prob
    return m, prob.astype(np.float32)


class TestRefine:
    def test_splits_touching_cells(self):
        mask, prob = _touching_cells_probability()
        res = refine_boundaries(prob)
        assert res.num_cells == 2
        binary_mask = prob < 0.5  # the watershed domain (reference :44-45)
        assert (res.labels[~binary_mask] == 0).all()
        assert (res.labels[binary_mask] > 0).all()
        assert res.labels[48, 40] != res.labels[48, 80]
        # areas roughly equal halves
        assert abs(res.areas[0] - res.areas[1]) < 0.2 * res.areas.sum()
        # nn distance ≈ center separation
        np.testing.assert_allclose(res.nn_distances, [40.0, 40.0], atol=2.0)

    def test_channel_selection(self):
        mask, prob = _touching_cells_probability()
        stack = np.stack([np.ones_like(prob)] * 3 + [prob])
        res = refine_boundaries(stack, RefineConfig(boundary_channel=3))
        assert res.num_cells == 2

    @pytest.mark.slow
    def test_tunnel_basins_config(self):
        """cfg.tunnel_basins routes through the basin-contraction
        watershed (ops.watershed docstring): same two-cell split on the
        pipeline fixture, and the sharded path composes as data
        parallelism (each plane floods single-device, bit-identical).

        slow: ~97 s of CPU compile for the tunnel + sharded graph pair
        (suite-trim, VERDICT r4 #6); the tunnel KEY semantics stay in the
        fast lane via the ops-level tunnel goldens and quantized-regime
        tests."""
        from particle_col_image_segmentation_tpu.models.refine import (
            refine_boundaries_sharded,
        )

        mask, prob = _touching_cells_probability()
        res = refine_boundaries(prob, RefineConfig(tunnel_basins=True))
        assert res.num_cells == 2
        assert res.labels[48, 40] != res.labels[48, 80]
        res_sh = refine_boundaries_sharded(
            prob, RefineConfig(tunnel_basins=True)
        )
        assert len(res_sh) == 1
        np.testing.assert_array_equal(res_sh[0].labels, res.labels)
        assert res_sh[0].num_cells == res.num_cells
        np.testing.assert_array_equal(res_sh[0].areas, res.areas)
        np.testing.assert_allclose(res_sh[0].centroids, res.centroids)

    def test_tunnel_size_guard(self):
        """An over-size plane through the tunneled data-parallel path must
        raise the targeted limit error (naming the alternatives) BEFORE
        dispatching — not OOM the device (VERDICT r4 #8)."""
        from particle_col_image_segmentation_tpu.models.refine import (
            _check_tunnel_chunk_fits,
        )

        class _TinyDev:
            def memory_stats(self):
                return {"bytes_limit": 1 * 1024**2}  # 1 MiB "chip"

        class _NoStatsDev:
            def memory_stats(self):
                return None

        with pytest.raises(ValueError, match="tunnel_basins.*Alternatives"):
            _check_tunnel_chunk_fits((512, 512), 1, _TinyDev())
        # fits: small plane against the same tiny limit
        _check_tunnel_chunk_fits((64, 64), 1, _TinyDev())
        # no stats available -> no size to check against: the guard is
        # skipped rather than assuming one device memory size
        _check_tunnel_chunk_fits((2048, 2048), 1, _NoStatsDev())
        _check_tunnel_chunk_fits((16384, 16384), 16, _NoStatsDev())

    def test_channel_selection_channel_last(self):
        # Ilastik's usual hdf5 export order is [H, W, C]
        mask, prob = _touching_cells_probability()
        stack = np.stack([np.ones_like(prob)] * 3 + [prob], axis=-1)
        res = refine_boundaries(stack, RefineConfig(boundary_channel=3))
        assert res.num_cells == 2

    def test_stack_matches_per_plane(self, tmp_path):
        """refine_boundaries_stack: one device graph over [Z,H,W], per-plane
        results bit-identical to refine_boundaries on each plane; channel
        layouts [Z,C,H,W] and [Z,H,W,C] both accepted; stack CSV carries a
        plane column."""
        from particle_col_image_segmentation_tpu.models.refine import (
            refine_boundaries_stack,
            write_refine_stack_csv,
        )

        mask, prob = _touching_cells_probability()
        stack = np.stack([prob, np.roll(prob, 11, axis=1)])
        results = refine_boundaries_stack(stack)
        assert len(results) == 2
        for z in range(2):
            single = refine_boundaries(stack[z])
            np.testing.assert_array_equal(results[z].labels, single.labels)
            assert results[z].num_cells == single.num_cells
            np.testing.assert_array_equal(results[z].areas, single.areas)
            np.testing.assert_allclose(
                results[z].centroids, single.centroids
            )
        # 4-D channel layouts (channel axis just before / after H,W)
        four = np.stack([np.ones_like(prob)] * 3 + [prob])  # [C,H,W]
        r_cf = refine_boundaries_stack(
            np.stack([four, four]), RefineConfig(boundary_channel=3)
        )
        r_cl = refine_boundaries_stack(
            np.stack([np.moveaxis(four, 0, -1)] * 2),
            RefineConfig(boundary_channel=3),
        )
        base = refine_boundaries(prob)
        for r in (*r_cf, *r_cl):
            np.testing.assert_array_equal(r.labels, base.labels)
        # a single [H,W,C] plane passed to the stack API must error loudly,
        # not flood H nonsense "planes" of [W,C]
        import pytest as _pytest
        with _pytest.raises(ValueError, match="single \\[H, W, C\\] plane"):
            refine_boundaries_stack(np.moveaxis(four, 0, -1))
        p = str(tmp_path / "stack.csv")
        write_refine_stack_csv(results, p)
        lines = open(p).read().strip().splitlines()
        assert lines[0] == "plane,cell,x_pos,y_pos,area_px,nn_distance_px"
        assert sum(ln.startswith("0,") for ln in lines[1:]) == results[0].num_cells
        assert sum(ln.startswith("1,") for ln in lines[1:]) == results[1].num_cells

    def test_refine_csv(self, tmp_path):
        from particle_col_image_segmentation_tpu.models.refine import write_refine_csv

        mask, prob = _touching_cells_probability()
        res = refine_boundaries(prob)
        p = str(tmp_path / "cells.csv")
        write_refine_csv(res, p)
        lines = open(p).read().strip().splitlines()
        assert lines[0] == "cell,x_pos,y_pos,area_px,nn_distance_px"
        assert len(lines) == 1 + res.num_cells
        assert lines[1].startswith("1,")

    def test_cross_strain_distances(self):
        a = np.array([[0.0, 0.0], [10.0, 0.0]])
        b = np.array([[0.0, 3.0]])
        d = cross_strain_distances(a, b)
        np.testing.assert_allclose(d["a_to_b"], [3.0, np.hypot(10, 3)], rtol=1e-5)
        np.testing.assert_allclose(d["b_to_a"], [3.0], rtol=1e-5)


def _painted_rois(size=96):
    """White canvas with red and green painted ROI disks."""
    rgb = np.full((size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[:size, :size]

    def paint(cy, cx, r, color):
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        rgb[m] = color

    paint(20, 20, 5, (255, 0, 0))
    paint(60, 60, 6, (255, 0, 0))
    paint(30, 70, 5, (0, 255, 0))
    return rgb


class TestNanoSIMS:
    def _isotopes(self, n=98, seed=0):
        rng = np.random.default_rng(seed)
        return {k: rng.random((n - 2, n - 2)) * 100 for k in nanosims.ISOTOPES}

    def test_class_masks(self):
        rgb = _painted_rois()
        red, green = nanosims.class_masks(rgb)
        assert red.sum() > 0 and green.sum() > 0
        assert not (red & green).any()

    def test_crop_to_content(self):
        rgb = np.full((50, 50, 3), 255, np.uint8)
        rgb[10:20, 15:30] = (255, 0, 0)  # blue=0 < 200 → content
        out = nanosims.crop_to_content(rgb)
        assert out.shape == (10, 15, 3)

    def test_analyze_roi_class_sums(self):
        iso = self._isotopes()
        # painted mask already at acquisition size → resize is identity
        mask = np.zeros((96, 96), bool)
        mask[10:20, 10:20] = True
        mask[50:60, 50:64] = True
        res = nanosims.analyze_roi_class(mask, iso)
        assert res.num_rois == 2
        # identity resize → sums equal plain masked sums
        m1 = np.zeros_like(mask)
        m1[10:20, 10:20] = True
        expected = np.sum(iso["C12"] * m1)
        np.testing.assert_allclose(res.sums[0, 0], expected, rtol=1e-5)
        # activities = C13/(C13+C12) etc.
        c12, c13 = res.sums[0, 0], res.sums[0, 1]
        np.testing.assert_allclose(res.activities[0, 0], c13 / (c13 + c12), rtol=1e-6)
        # positions: 1-based centroid of the solid mask
        np.testing.assert_allclose(res.positions[0], [14.5 + 1, 14.5 + 1], atol=0.6)

    def test_dissolved_roi_centroid_is_nan(self):
        """A real ROI whose antialias-downscale leaves no solid pixel has no
        centroid — NaN, never a silent (1, 1) corner coordinate."""
        acq = 32
        Hp = Wp = 96  # 3x downscale dissolves a 2-px ROI
        mask = np.zeros((Hp, Wp), bool)
        mask[10:40, 10:40] = True      # survives the downscale
        mask[80:82, 80:82] = True      # dissolves
        iso = {
            k: np.ones((acq, acq), np.float32) for k in nanosims.ISOTOPES
        }
        res = nanosims.analyze_roi_class(mask, iso)
        assert res.num_rois == 2
        assert np.isfinite(res.positions[0]).all()
        assert np.isnan(res.positions[1]).all()

    def test_single_class_nearest_is_nan_19col(self, tmp_path):
        """Only one painted class: data_dist_nearest.csv still gets written
        (NaN nearest — there is no other-class neighbor) and the bound CSV
        keeps its documented 19 columns."""
        size = 96
        rgb = np.full((size, size, 3), 255, np.uint8)
        yy, xx = np.mgrid[:size, :size]
        rgb[(yy - 20) ** 2 + (xx - 20) ** 2 <= 25] = (255, 0, 0)
        rgb[(yy - 60) ** 2 + (xx - 60) ** 2 <= 36] = (255, 0, 0)
        iso = self._isotopes()
        res = nanosims.analyze_nanosims(iso, rgb)
        assert res.red.num_rois == 2 and res.green.num_rois == 0
        assert res.nearest is not None and np.isnan(res.nearest).all()
        # bound CSV layout check through the driver
        import os

        from PIL import Image

        md = tmp_path / "mats"
        md.mkdir()
        from scipy.io import savemat

        mat_names = ("12C", "13C", "14N12C", "15N12C", "16O", "17O", "18O",
                     "Esi")
        for k in mat_names:
            savemat(str(md / f"{k}.mat"), {"IM": np.ones((size + 2, size + 2))})
        Image.fromarray(rgb).save(str(tmp_path / "rois.png"))
        bound = np.full((size, size, 3), 255, np.uint8)
        bound[40:42, 10:80] = (255, 0, 0)
        Image.fromarray(bound).save(str(tmp_path / "bound.png"))
        nanosims.run_nanosims(
            str(md), str(tmp_path / "rois.png"),
            bound_png=str(tmp_path / "bound.png"),
            out_dir=str(tmp_path), make_figures=False,
        )
        rows = open(tmp_path / "data_dist_nearest_bound.csv").read().strip().splitlines()
        assert all(len(r.split(",")) == 19 for r in rows)
        assert os.path.exists(tmp_path / "data_dist_nearest.csv")

    def test_solid_mask_ignores_float32_rounding(self):
        """A ROI interior resizes to 1 up to float32 rounding, on either
        side of 1 depending on the device's summation order: the solid
        mask must not depend on which side, while partial edge coverage
        stays out."""
        import jax.numpy as jnp

        v = np.array([1.0, np.nextafter(np.float32(1), np.float32(0)),
                      1.0 + 1e-6, 1.07, 0.9999, 0.5, 0.0], np.float32)
        got = np.asarray(nanosims._solid(jnp.asarray(v)))
        np.testing.assert_array_equal(
            got, [True, True, True, True, False, False, False]
        )

    def test_batched_roi_path_matches_sequential(self):
        """A/B (VERDICT r1 #5): the adjoint-resize isotope sums and the
        chunked batched centroids must match the sequential per-ROI scan
        (the literal MATLAB loop shape) — including a painted size different
        from the acquisition size, so the resize is NOT identity."""
        import jax.numpy as jnp

        rng = np.random.default_rng(5)
        acq = 64
        Hp = Wp = 96  # painted space larger than acquisition space
        mask = np.zeros((Hp, Wp), bool)
        mask[8:24, 10:30] = True
        mask[40:60, 50:70] = True
        mask[70:90, 12:28] = True
        iso = {
            k: rng.random((acq, acq)).astype(np.float32)
            for k in ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18")
        }
        res = nanosims.analyze_roi_class(mask, iso)
        assert res.num_rois == 3

        from particle_col_image_segmentation_tpu.models.nanosims import (
            _SUM_ORDER,
            _roi_scan,
        )
        from particle_col_image_segmentation_tpu.ops import (
            connected_components,
        )
        from particle_col_image_segmentation_tpu.ops.ccl import compact_labels

        rawT = connected_components(
            jnp.asarray(mask.T, jnp.uint8), background=0, num_classes=2
        )
        labelsT, _ = compact_labels(rawT, 64)
        labels = jnp.swapaxes(labelsT, 0, 1)
        iso_stack = jnp.asarray(
            np.stack([iso[k] for k in _SUM_ORDER]), jnp.float32
        )
        ref_sums, ref_cents = _roi_scan(labels, iso_stack, 16, acq)
        np.testing.assert_allclose(
            res.sums, np.asarray(ref_sums)[:3], rtol=2e-5, atol=1e-3
        )
        # borderline solid-threshold pixels may flip between the matmul
        # resize and jax.image.resize's internal op order; centroids move
        # by ≪ a pixel
        np.testing.assert_allclose(
            res.positions, np.asarray(ref_cents)[:3], atol=0.05
        )

    def test_compat_imcrop_rect(self):
        """VERDICT r1 #9: compat_imcrop_rect reproduces MATLAB imcrop's
        half-pixel rect (one extra row+col past the content extent, clamped
        at the image edge); default stays the tight content bbox."""
        rgb = np.full((40, 50, 3), 255, np.uint8)
        rgb[10:20, 15:30] = (255, 0, 0)  # blue=0 < 200 → content
        tight = nanosims.crop_to_content(rgb)
        assert tight.shape == (10, 15, 3)
        matlab = nanosims.crop_to_content(rgb, imcrop_rect=True)
        assert matlab.shape == (11, 16, 3)
        np.testing.assert_array_equal(matlab[:10, :15], tight)
        # clamped at the image edge: content touching the bottom-right
        rgb2 = np.full((40, 50, 3), 255, np.uint8)
        rgb2[30:40, 35:50] = (255, 0, 0)
        assert nanosims.crop_to_content(rgb2, imcrop_rect=True).shape == (10, 15, 3)
        # end-to-end: the flag changes the painted-space shape analyzed
        from particle_col_image_segmentation_tpu.config import NanoSIMSConfig

        rng = np.random.default_rng(6)
        iso = {
            k: rng.random((32, 32)).astype(np.float32)
            for k in ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18")
        }
        res_t = nanosims.analyze_nanosims(iso, rgb)
        res_m = nanosims.analyze_nanosims(
            iso, rgb, NanoSIMSConfig(compat_imcrop_rect=True)
        )
        assert res_t.red.labels.shape == (10, 15)
        assert res_m.red.labels.shape == (11, 16)
        # the crop shift changes the resize geometry and thus the ROI sums
        assert not np.allclose(res_t.red.sums, res_m.red.sums)

    def test_roi_order_is_matlab_column_major(self):
        """Regression: ROI ids were raster (row-major) ordered; MATLAB
        regionprops numbers by COLUMN-major first pixel, which defines the
        .m script's ROI index and every CSV row order."""
        iso = self._isotopes()
        mask = np.zeros((96, 96), bool)
        mask[0:6, 50:56] = True    # raster-first, but column 50
        mask[40:46, 3:9] = True    # later rows, but column 3 → MATLAB first
        res = nanosims.analyze_roi_class(mask, iso)
        assert res.num_rois == 2
        # positions are (x=col, y=row) 1-based: ROI 1 must be the column-3 one
        assert res.positions[0][0] < res.positions[1][0]

    def test_deuterium_variant(self, tmp_path):
        """The .m script's commented-out 1H/2H variant (:13-14,:26-27): when
        1H.mat/2H.mat are present, a data_deuterium.csv sidecar reports
        D activity = 2H/(1H+2H) per ROI; the 5-isotope outputs unchanged."""
        from scipy.io import savemat

        rng = np.random.default_rng(7)
        names = {"14N12C": 1, "15N12C": 1, "12C": 1, "13C": 1, "16O": 1,
                 "17O": 1, "18O": 1, "Esi": 1, "1H": 1, "2H": 1}
        for f in names:
            savemat(str(tmp_path / f"{f}.mat"),
                    {"IM": rng.poisson(50, (98, 98)).astype(np.float64)})
        from PIL import Image

        rgb = np.zeros((108, 108, 3), np.uint8)
        rgb[..., 2] = 255
        rgb[10:20, 10:22] = (255, 0, 0)
        Image.fromarray(rgb).save(str(tmp_path / "rois.png"))
        res = nanosims.run_nanosims(
            str(tmp_path), str(tmp_path / "rois.png"),
            out_dir=str(tmp_path), make_figures=False,
        )
        assert res.red.h_sums is not None and res.red.h_sums.shape == (1, 2)
        h1, h2 = res.red.h_sums[0]
        np.testing.assert_allclose(res.red.d_activity[0], h2 / (h1 + h2))
        rows = open(str(tmp_path / "data_deuterium.csv")).read().strip().splitlines()
        assert len(rows) == 1 and rows[0].startswith("1,1,")
        # 5-isotope outputs untouched: data.csv still 17 columns
        assert len(open(str(tmp_path / "data.csv")).readline().split(",")) == 17

    def test_uint8_display_matlab_rounding(self):
        """Regression: np.round's half-to-even differed from MATLAB uint8's
        half-away-from-zero at exact .5; and NaN pixels must cast to 0."""
        raw = np.array([[1.0, 510.0]])
        out = nanosims.to_uint8_display(raw)  # 1*255/510 = 0.5 exactly
        assert out[0, 0] == 1  # MATLAB uint8(0.5) = 1 (np.round gives 0)
        ratio = nanosims.ratio_image(
            np.array([[0.0, 5.0]]), np.array([[0.0, 5.0]])
        )
        assert ratio[0, 0] == 0  # 0/0 = NaN → uint8(NaN) = 0 in MATLAB
        assert ratio[0, 1] == 255

    def test_full_analysis_and_rows(self):
        iso = self._isotopes()
        rgb = _painted_rois()
        res = nanosims.analyze_nanosims(iso, rgb)
        assert res.red.num_rois == 2 and res.green.num_rois == 1
        assert res.all_data.shape == (3, 17)
        # class column and index column
        np.testing.assert_array_equal(res.all_data[:, 0], [1, 1, 2])
        np.testing.assert_array_equal(res.all_data[:, 1], [1, 2, 1])
        # act*100 columns are consistent
        np.testing.assert_allclose(
            res.all_data[:, 13:17], res.all_data[:, 9:13] * 100, rtol=1e-12
        )
        assert res.data_xy.shape == (3, 19)
        assert res.nearest is not None and res.nearest.shape == (3,)
        # activity maps nonzero only on ROIs
        assert (res.activity_images["N"] > 0).sum() > 0

    def test_run_nanosims_csvs(self, tmp_path):
        from PIL import Image

        from scipy.io import savemat

        n = 98
        rng = np.random.default_rng(1)
        names = {
            "N14C12": "14N12C.mat", "N15C12": "15N12C.mat", "C12": "12C.mat",
            "C13": "13C.mat", "O16": "16O.mat", "O17": "17O.mat",
            "O18": "18O.mat", "ESI": "Esi.mat",
        }
        for fname in names.values():
            savemat(str(tmp_path / fname), {"IM": rng.random((n, n)) * 50})
        rgb = _painted_rois(n - 2)
        Image.fromarray(rgb).save(str(tmp_path / "rois.png"))
        bound = np.full((n - 2, n - 2, 3), 255, np.uint8)
        bound[40:50, 10:80] = (255, 0, 0)
        Image.fromarray(bound).save(str(tmp_path / "bound.png"))

        out = tmp_path / "out"
        out.mkdir()
        res = nanosims.run_nanosims(
            str(tmp_path), str(tmp_path / "rois.png"), str(tmp_path / "bound.png"),
            str(out), NanoSIMSConfig(),
        )
        for f in (
            "data.csv", "data_xy.csv", "data_dist_nearest.csv",
            "data_dist_nearest_bound.csv",
        ):
            assert (out / f).exists(), f
        rows = open(out / "data.csv").read().strip().splitlines()
        assert len(rows) == res.red.num_rois + res.green.num_rois
        bound_rows = open(out / "data_dist_nearest_bound.csv").read().strip().splitlines()
        assert len(bound_rows[0].split(",")) == 19  # 17 + nearest + bound dist

    def test_display_images(self):
        iso = self._isotopes()
        imgs = nanosims.display_images(iso)
        for key in ("C12", "N15ratioimg", "C13ratimg", "O18ratioimg", "N14C12ESIratio"):
            assert imgs[key].dtype == np.uint8
            assert imgs[key].max() == 255  # normalized to full scale

    def test_figures_written(self, tmp_path):
        iso = self._isotopes()
        rgb = _painted_rois()
        res = nanosims.analyze_nanosims(iso, rgb)
        from particle_col_image_segmentation_tpu.viz.nanosims_figures import save_all

        bound = np.zeros(rgb.shape[:2], bool)
        bound[40:50, 10:80] = True
        save_all(res, rgb, nanosims.to_uint8_display(iso["N14C12"]), str(tmp_path),
                 bound_mask=bound)
        import os

        for f in ("rois_clear.png", "annotations.png", "cell position.png",
                  "agg_boundary.png"):
            assert os.path.getsize(tmp_path / f) > 5000, f

    def test_green_o_bug_compat(self):
        iso = self._isotopes()
        rgb = _painted_rois()
        fixed = nanosims.analyze_nanosims(iso, rgb, NanoSIMSConfig())
        buggy = nanosims.analyze_nanosims(
            iso, rgb, NanoSIMSConfig(compat_green_o_bug=True)
        )
        # combined maps identical; per-class O maps shifted into red
        np.testing.assert_allclose(
            fixed.activity_images["O17"], buggy.activity_images["O17"]
        )
        assert (buggy.green.activity_images["O17"] == 0).all()
        assert (fixed.green.activity_images["O17"] > 0).any()
