"""External validation of the hand-written oracle (VERDICT r1 weak #1).

skimage/tifffile are not installable in this environment (no egress), so the
oracle cannot be diffed against real skimage outputs here.  These tests
break the oracle-validates-the-device circularity as far as the environment
allows, using only INDEPENDENT implementations:

* scipy.ndimage (an independent C library) for partitions, filters,
  region statistics;
* direct invariant checks for the skimage behaviors the oracle hand-codes
  (raster-order label ids, plateau maxima, minimax-optimal watershed);
* hand-traced goldens for skimage's priority-flood queue semantics (seed
  age by raster order, FIFO plateau ties, pit pixels jumping the queue) —
  each derived step by step from the published algorithm, with the trace
  recorded in the test body.
"""

import numpy as np
import pytest
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu.oracle import ndimage as ond


def _shift(x, dy, dx, fill):
    H, W = x.shape
    out = np.full_like(x, fill)
    ys = slice(max(0, -dy), H - max(0, dy))
    yd = slice(max(0, dy), H - max(0, -dy))
    xs = slice(max(0, -dx), W - max(0, dx))
    xd = slice(max(0, dx), W - max(0, -dx))
    out[yd, xd] = x[ys, xs]
    return out


class TestLabelVsScipy:
    """oracle.label must partition exactly like scipy per-value labeling and
    order ids by raster position of first pixel (the skimage contract)."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("connectivity", [1, 2])
    @pytest.mark.parametrize("n_vals", [3, 40])  # 40 → the sparse-graph path
    def test_partition_and_order(self, seed, connectivity, n_vals):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, n_vals, (48, 56)).astype(np.int32)
        img = ndi.grey_dilation(img, size=2)  # larger regions
        out, n = ond.label(
            img, background=-1, connectivity=connectivity, return_num=True
        )
        # (a) same partition as independent per-value scipy labeling
        structure = (
            np.ones((3, 3), bool) if connectivity == 2
            else ndi.generate_binary_structure(2, 1)
        )
        comp_sets = set()
        for v in np.unique(img):
            comp, k = ndi.label(img == v, structure=structure)
            for i in range(1, k + 1):
                comp_sets.add(frozenset(np.flatnonzero((comp == i).ravel())))
        our_sets = {
            frozenset(np.flatnonzero((out == i).ravel()))
            for i in range(1, n + 1)
        }
        assert our_sets == comp_sets
        # (b) ids ordered by raster position of first occurrence
        flat = out.ravel()
        uniq, first = np.unique(flat, return_index=True)
        pos = {int(u): int(f) for u, f in zip(uniq, first)}
        firsts = [pos[i] for i in range(1, n + 1)]
        assert firsts == sorted(firsts)
        assert firsts[0] == 0  # raster-first pixel gets id 1 (background=-1)

    def test_background_zero(self):
        img = np.array([[0, 1, 0], [1, 1, 0], [0, 0, 2]], np.uint8)
        out = ond.label(img)  # background=0
        assert (out[img == 0] == 0).all()
        assert out[0, 1] == out[1, 0] == out[1, 1] == 1  # 8-connected
        assert out[2, 2] == 2


class TestRegionpropsVsScipy:
    @pytest.mark.parametrize("seed", [3, 4])
    def test_stats_match_scipy(self, seed):
        rng = np.random.default_rng(seed)
        img = (rng.random((40, 40)) < 0.25).astype(np.uint8)
        lab = ond.label(img)
        regions = ond.regionprops(lab)
        ids = [r.label for r in regions]
        areas = ndi.sum_labels(np.ones_like(lab), lab, ids)
        coms = ndi.center_of_mass(np.ones_like(lab), lab, ids)
        objs = ndi.find_objects(lab)
        for r, a, com in zip(regions, areas, coms):
            assert r.area == int(a)
            np.testing.assert_allclose(r.centroid, com)
            sl = objs[r.label - 1]
            assert r.bbox == (
                sl[0].start, sl[1].start, sl[0].stop, sl[1].stop
            )

    def test_absent_ids_skipped(self):
        lab = np.zeros((5, 5), np.int64)
        lab[0, 0] = 1
        lab[4, 4] = 3  # id 2 absent
        regions = ond.regionprops(lab)
        assert [r.label for r in regions] == [1, 3]


def _local_maxima_independent(img, connectivity=2):
    """Pure-scipy plateau maxima: spread 'has a higher neighbor' through
    equal-value adjacency until fixpoint — no reuse of oracle.label."""
    offsets = [
        (dy, dx)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
        and (connectivity == 2 or abs(dy) + abs(dx) == 1)
    ]
    bad = np.zeros(img.shape, bool)
    for dy, dx in offsets:
        bad |= _shift(img, dy, dx, -np.inf) > img
    while True:
        new = bad.copy()
        for dy, dx in offsets:
            new |= _shift(bad, dy, dx, False) & (
                _shift(img, dy, dx, np.nan) == img
            )
        if (new == bad).all():
            return ~bad
        bad = new


class TestLocalMaximaIndependent:
    @pytest.mark.parametrize("seed", [0, 5, 6])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_quantized_random(self, seed, connectivity):
        rng = np.random.default_rng(seed)
        img = (rng.random((40, 44)) * 6).astype(np.int32).astype(np.float64)
        ours = ond.local_maxima(img, connectivity=connectivity)
        ref = _local_maxima_independent(img, connectivity=connectivity)
        np.testing.assert_array_equal(ours, ref)

    def test_border_plateau(self):
        # a plateau touching the border counts (allow_borders=True)
        img = np.zeros((5, 6))
        img[0, :3] = 2.0
        img[3, 4] = 1.0
        out = ond.local_maxima(img)
        assert out[0, :3].all() and out[3, 4]
        assert not out[img == 0].any()


def _minimax_costs(img, seed_mask, mask, connectivity=1):
    """Per-seed-set minimax cost by Bellman-Ford (independent check)."""
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    INF = np.inf
    cost = np.where(seed_mask & mask, img, INF)
    while True:
        best = cost.copy()
        for dy, dx in offsets:
            nc = _shift(cost, dy, dx, INF)
            best = np.minimum(best, np.maximum(nc, img))
        best = np.where(seed_mask & mask, cost, np.where(mask, best, INF))
        if (best == cost).all():
            return cost
        cost = best


class TestWatershedProperties:
    """Algorithm-level invariants of the priority flood, checked on random
    fixtures (no reimplementation of the queue involved)."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_minimax_optimal_assignment(self, seed):
        rng = np.random.default_rng(seed)
        img = np.round(rng.random((24, 28)) * 8)
        markers = np.zeros(img.shape, np.int64)
        sites = rng.integers(0, 24, (4, 2))
        for i, (y, x) in enumerate(sites):
            markers[y, x % 28] = i + 1
        mask = np.ones(img.shape, bool)
        out = ond.watershed(img, markers, mask=mask)
        assert (out > 0).all()  # fully flooded
        # every pixel's assigned basin must achieve the globally minimal
        # minimax cost over all markers (ties may go to any achiever)
        per_marker = [
            _minimax_costs(img, markers == i + 1, mask) for i in range(4)
        ]
        all_costs = np.stack(per_marker)
        opt = all_costs.min(axis=0)
        assigned = np.take_along_axis(all_costs, out[None] - 1, axis=0)[0]
        np.testing.assert_array_equal(assigned, opt)

    def test_seeds_and_mask_respected(self):
        rng = np.random.default_rng(2)
        img = rng.random((16, 16))
        markers = np.zeros((16, 16), np.int64)
        markers[2, 2] = 5
        markers[12, 12] = 3
        mask = np.zeros((16, 16), bool)
        mask[1:15, 1:15] = True
        out = ond.watershed(img, markers, mask=mask)
        assert out[2, 2] == 5 and out[12, 12] == 3
        assert (out[~mask] == 0).all() and (out[mask] > 0).all()


class TestWatershedHandGoldens:
    """Queue-order semantics pinned by hand-traced executions of skimage's
    published algorithm (push seeds in raster order with ages; pop by
    (value, age); label neighbors at claim time; push at their OWN img)."""

    def test_plateau_fifo_split(self):
        # img all equal; seeds at both ends of a 1×5 line.
        # trace: pop seed1(age0) → claims x=1; pop seed2(age1) → claims x=3;
        # pop x=1(age2) → claims x=2.  Middle goes to marker 1.
        img = np.zeros((1, 5))
        markers = np.array([[1, 0, 0, 0, 2]])
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(out, [[1, 1, 1, 2, 2]])

    def test_seed_age_is_raster_order_not_id(self):
        # same as above with marker ids swapped: the RASTER-FIRST seed pops
        # first regardless of its id, so the middle goes to marker 2.
        img = np.zeros((1, 5))
        markers = np.array([[2, 0, 0, 0, 1]])
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(out, [[2, 2, 2, 1, 1]])

    def test_even_plateau_alternating_claims(self):
        # 1×6 plateau: pops alternate seed1, seed2, wave1, wave2 → 3/3 split
        img = np.zeros((1, 6))
        markers = np.array([[1, 0, 0, 0, 0, 2]])
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(out, [[1, 1, 1, 2, 2, 2]])

    def test_pit_floods_from_first_breacher(self):
        # img [0,5,1,1,5,0], seeds at both ends.  trace: s1 pops (claims
        # x=1, pushed at 5); s2 pops (claims x=4, pushed at 5); x=1 pops at
        # (5, age2) → claims x=2 (pushed at ITS OWN img 1 — jumps the
        # queue); x=2 pops at (1,·) before x=4's (5, age3) → claims x=3.
        # The whole pit belongs to marker 1.
        img = np.array([[0.0, 5.0, 1.0, 1.0, 5.0, 0.0]])
        markers = np.array([[1, 0, 0, 0, 0, 2]])
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(out, [[1, 1, 1, 1, 2, 2]])

    def test_lower_barrier_wins_pit_interior(self):
        # barriers 3 (left) vs 5 (right): the lower barrier breaches first
        # at priority 3 and floods the PIT INTERIOR before the 5-barrier
        # side advances.  The 5-barrier pixel itself was already claimed by
        # its adjacent seed at time 1 (labeling happens at claim/push time,
        # not pop time), so it keeps marker 2.
        img = np.array([[0.0, 3.0, 1.0, 1.0, 5.0, 0.0]])
        markers = np.array([[1, 0, 0, 0, 0, 2]])
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(out, [[1, 1, 1, 1, 2, 2]])

    def test_quantized_basin_tunnels_wave(self):
        # THE quantized-plateau mechanism behind the sparse-seed IoU gap
        # (PERF.md round-3 watershed section): a basin below the
        # plateau level acts as a TUNNEL — pops at img < level jump the
        # queue, so a wave that touches a basin rim floods the whole basin
        # and re-enters the plateau within ~one BFS round, regardless of
        # basin width.  img [2,2,2,1,1,1,2,2,2,2,2,2], seeds x0/x11.
        # trace: s1(2,a0) pops→x1; s2(2,a1)→x10; x1(2,a2)→x2; x10(2,a3)→x9;
        # x2(2,a4)→x3 pushed at ITS OWN img (1,a6); x3 pops BEFORE x9's
        # (2,a5)→x4(1,a7); x4→x5(1,a8); x5→x6 pushed (2,a9); x9(2,a5) only
        # now→x8; x6(2,a9)→x7 claims for marker 1.  Marker 1 takes 8 of 12
        # cells despite x7 being only 4 BFS steps from s2 and 7 from s1 —
        # geodesic distance does NOT govern plateau claims across basins.
        img = np.array([[2.0, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2]])
        markers = np.zeros((1, 12), np.int64)
        markers[0, 0] = 1
        markers[0, 11] = 2
        out = ond.watershed(img, markers)
        np.testing.assert_array_equal(
            out, [[1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2]]
        )

    def test_2d_plateau_corner_race(self):
        # 3×3 zeros, seeds at opposite corners (raster: (0,0) first).
        # trace: s1(age0) pops → claims (0,1),(1,0),(1,1) [8-conn? default
        # connectivity=1 → claims (0,1),(1,0)]; s2 pops → claims (1,2),(2,1);
        # (0,1) pops → claims (0,2)... wait 4-conn: (0,1)'s unlabeled nbrs:
        # (0,2),(1,1) → both to 1; (1,0) pops → (2,0) to 1; (1,2) pops →
        # nothing new except (0,2)(taken),(2,2); (2,2)→2; (2,1) pops →
        # (2,0) taken... final: marker 1 gets (0,0),(0,1),(1,0),(0,2),(1,1),
        # (2,0); marker 2 gets (2,2),(1,2),(2,1).
        img = np.zeros((3, 3))
        markers = np.zeros((3, 3), np.int64)
        markers[0, 0] = 1
        markers[2, 2] = 2
        out = ond.watershed(img, markers)
        expected = np.array([[1, 1, 1], [1, 1, 2], [1, 2, 2]])
        np.testing.assert_array_equal(out, expected)
