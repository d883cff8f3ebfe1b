"""Metric tests + randomized parity fuzzing (many seeds, CPU)."""

import numpy as np
import pytest
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import (
    connected_components,
    dilate_disk,
    label_image,
    median_label_filter,
)
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu.utils.metrics import (
    boundary_iou,
    label_boundaries,
    masks_equal,
)

from fixtures import random_binary, random_class_plane


class TestMetrics:
    def test_boundary_iou_identity(self):
        lab = ond.label(random_class_plane((48, 48), 3, seed=1), background=-1)
        assert boundary_iou(lab, lab) == 1.0

    def test_boundary_iou_detects_shift(self):
        lab = np.zeros((32, 32), int)
        lab[8:24, 8:24] = 1
        shifted = np.roll(lab, 4, axis=0)
        assert boundary_iou(lab, shifted) < 0.9

    def test_boundary_iou_tolerates_one_px(self):
        lab = np.zeros((32, 32), int)
        lab[8:24, 8:24] = 1
        off1 = np.zeros((32, 32), int)
        off1[8:24, 9:25] = 1  # 1-px slide
        assert boundary_iou(lab, off1, tolerance_px=1) > 0.6
        assert boundary_iou(lab, off1, tolerance_px=2) > 0.75

    def test_label_boundaries(self):
        lab = np.zeros((8, 8), int)
        lab[2:6, 2:6] = 1
        b = label_boundaries(lab)
        assert b[2, 2] and b[1, 2] and not b[4, 4] and not b[0, 0]

    def test_masks_equal(self):
        a = np.arange(9).reshape(3, 3)
        assert masks_equal(a, a.copy())
        assert not masks_equal(a, a + 1)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_ccl_median_parity(seed):
    """Randomized structure sizes/densities against scipy + oracle."""
    rng = np.random.default_rng(seed)
    h = int(rng.choice([33, 48, 64, 96]))
    w = int(rng.choice([40, 64, 80]))
    n_classes = int(rng.integers(2, 6))
    img = rng.integers(1, n_classes + 1, (h, w)).astype(np.uint8)

    med = np.asarray(median_label_filter(jnp.asarray(img), size=5))
    np.testing.assert_array_equal(med, ndi.median_filter(img, size=5))

    seg, num = label_image(jnp.asarray(med), background=None, max_regions=h * w)
    ref, ref_n = ond.label(med, background=-1, return_num=True)
    assert int(num) == ref_n
    np.testing.assert_array_equal(np.asarray(seg), ref)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_dilation_parity(seed):
    rng = np.random.default_rng(100 + seed)
    r = int(rng.integers(1, 9))
    m = random_binary((72, 72), p=float(rng.uniform(0.01, 0.3)), seed=seed)
    ours = np.asarray(dilate_disk(jnp.asarray(m), r))
    np.testing.assert_array_equal(ours, ond.binary_dilation(m, ond.disk(r)))


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_region_tables(seed):
    """Randomized oracle parity of the table family: compaction, counts,
    full table, lookup — shapes, class counts, and background varied per
    seed."""
    from particle_col_image_segmentation_tpu.ops.ccl import (
        compact_labels,
        connected_components,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        centroids_f64,
        region_counts,
        region_props,
        table_lookup,
    )

    rng = np.random.default_rng(200 + seed)
    h = int(rng.choice([32, 64]))
    w = int(rng.choice([128, 256]))
    n_classes = int(rng.integers(2, 6))
    bg = int(rng.integers(0, 2)) or None  # None or 1
    img = rng.integers(0, n_classes, (h, w)).astype(np.uint8)

    raw = connected_components(
        jnp.asarray(img), background=bg, num_classes=n_classes
    )
    R = h * w  # capacity ≥ any possible component count
    s0, n0 = compact_labels(raw, R)
    ref, ref_n = ond.label(
        img, background=-1 if bg is None else bg, return_num=True
    )
    assert int(n0) == ref_n
    np.testing.assert_array_equal(np.asarray(s0), ref)

    a0, c0 = region_counts(s0, jnp.asarray(img), R)
    area = np.bincount(ref.ravel(), minlength=R + 1)
    np.testing.assert_array_equal(np.asarray(a0)[1:], area[1:])
    valid = area > 0
    valid[0] = False
    cls = np.zeros(R + 1, np.int64)
    np.maximum.at(cls, ref.ravel(), img.ravel().astype(np.int64))
    np.testing.assert_array_equal(np.asarray(c0)[valid], cls[valid])

    t0 = region_props(s0, jnp.asarray(img), R)
    np.testing.assert_array_equal(np.asarray(t0.valid), valid)
    cy, cx = centroids_f64(t0)
    for r in ond.regionprops(ref)[:64]:
        assert int(t0.area[r.label]) == r.area
        np.testing.assert_allclose(
            (cy[r.label], cx[r.label]), r.centroid, rtol=0, atol=1e-9
        )
        assert tuple(np.asarray(t0.bbox[r.label])) == r.bbox

    tab = rng.integers(0, 256, R + 1).astype(np.int32)
    lk = table_lookup(s0, jnp.asarray(tab))
    np.testing.assert_array_equal(np.asarray(lk), tab[np.asarray(s0)])
