"""Soak-level randomized parity sweep: full single-channel analysis
(device graph) vs the CPU oracle over many seeds/shapes/strain sets.

The pytest fuzz (tests/test_metrics_fuzz.py) covers the kernel family with
a handful of seeds per op; this script drives the WHOLE analyze_plane graph
— denoise, CCL, tables, area partition, proximity merge, particle fill —
against oracle/reference_pipeline for hundreds of seeds, as a background
validation of the parity claims.  Any mismatch prints the failing seed and
exits 1 (reproduce with the pytest-style asserts below).

Usage:  JAX_PLATFORMS=cpu python scripts/soak_fuzz.py [n_seeds]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"
))

import jax

# pin the CPU backend in the config too, so an installed GPU plugin cannot
# take the default (cf. tests/conftest.py)
jax.config.update("jax_platforms", "cpu")

import numpy as np

from particle_col_image_segmentation_tpu.config import AnalysisConfig
from fixtures import synthetic_label_plane

STRAIN_SETS = [
    {1: "3D05", 2: "Particle", 3: "Background"},
    {1: "6B07", 2: "Particle", 3: "Background"},
    {1: "3D05", 2: "C3M10", 3: "Particle", 4: "Background"},
    {1: "3D05", 2: "6B07", 3: "C3M10", 4: "Particle", 5: "Background"},
]
SHAPES = [(96, 96), (128, 192), (192, 192), (160, 224)]


def check_seed(seed: int) -> None:
    from parity import assert_plane_parity

    rng = np.random.default_rng(seed)
    cell_types = STRAIN_SETS[int(rng.integers(len(STRAIN_SETS)))]
    shape = SHAPES[int(rng.integers(len(SHAPES)))]
    cfg = AnalysisConfig(max_regions=4096)
    img = synthetic_label_plane(seed=seed, cell_types=cell_types, shape=shape)
    assert_plane_parity(img, cell_types, cfg)


def check_experiment_seed(seed: int, tmp_root: str) -> None:
    """Randomized single-file experiment folder → the three CSVs must match
    an independent oracle replication of the reference flow byte-for-byte."""
    import shutil

    from particle_col_image_segmentation_tpu.io.hdf5 import save_h5_plane
    from particle_col_image_segmentation_tpu.models import experiment
    from particle_col_image_segmentation_tpu.oracle import reference_pipeline as rp
    from particle_col_image_segmentation_tpu.report.csvio import (
        write_cell_position_info,
        write_density_info,
        write_merged_cell_position_info,
    )

    rng = np.random.default_rng(10_000 + seed)
    cell_types = STRAIN_SETS[int(rng.integers(len(STRAIN_SETS)))]
    # the file flow goes through normalize_ds_arr, which (like the
    # reference's 2048² assumption, relaxed to any square) requires square
    square = [s for s in SHAPES if s[0] == s[1]]
    shape = square[int(rng.integers(len(square)))]
    cfg = AnalysisConfig(max_regions=4096)
    strains = [n for n in cell_types.values() if n not in ("Particle", "Background")]
    name = f"Tp_{'_'.join(strains)}_s{seed}"
    folder = os.path.join(tmp_root, f"exp{seed}", "24h", name)
    os.makedirs(folder)
    img = synthetic_label_plane(seed=10_000 + seed, cell_types=cell_types, shape=shape)
    save_h5_plane(os.path.join(folder, name + "_labels.h5"), img)
    experiment.process_single_h5_file(
        folder, name + "_labels.h5", cfg, make_figures=False
    )

    den = rp.denoise(img, cfg)
    pos, clusters, particle_area, merged = rp.get_cell_positions_and_areas(
        den, cell_types, merged=True, cfg=cfg
    )
    counts, dens, ratios = rp.get_cell_counts_and_densities(
        pos, clusters, particle_area, cfg
    )
    _, filled_area = rp.recreate_particle_area(
        den.copy(), cell_types, particle_area, cfg
    )
    exp_dir = os.path.join(tmp_root, f"expected{seed}")
    os.makedirs(exp_dir)
    write_cell_position_info(
        pos, clusters, os.path.join(exp_dir, "pos.csv"), filled_area, cfg
    )
    write_merged_cell_position_info(
        merged, os.path.join(exp_dir, "merged.csv"), filled_area, cfg
    )
    write_density_info(
        os.path.join(exp_dir, "density.csv"), name, dens, ratios, counts
    )

    def read(p):
        with open(p) as f:
            return f.read()

    assert read(os.path.join(folder, name + "_cell_pos.csv")) == read(
        os.path.join(exp_dir, "pos.csv")
    )
    assert read(os.path.join(folder, name + "_merged_cell_pos.csv")) == read(
        os.path.join(exp_dir, "merged.csv")
    )
    assert read(
        os.path.join(os.path.dirname(folder), f"exp{seed}_24h_cell_density_info.csv")
    ) == read(os.path.join(exp_dir, "density.csv"))
    shutil.rmtree(os.path.join(tmp_root, f"exp{seed}"))
    shutil.rmtree(exp_dir)


def check_refine_seed(seed: int) -> None:
    """Randomized touching-cell reliefs → the batched stack refine must be
    bit-identical per plane to the single-plane path, and every plane must
    converge (fixed shape across seeds so the soak reuses one compile)."""
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu.models.refine import (
        refine_boundaries,
        refine_boundaries_stack,
    )

    rng = np.random.default_rng(20_000 + seed)
    H, W = 96, 128
    yy, xx = np.mgrid[:H, :W]
    planes = []
    for _ in range(3):
        m = np.zeros((H, W), bool)
        for _ in range(int(rng.integers(2, 7))):
            cy, cx = rng.integers(12, H - 12), rng.integers(12, W - 12)
            r2 = int(rng.integers(40, 160))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
            m |= (yy - cy) ** 2 + (xx - cx - int(1.4 * np.sqrt(r2))) ** 2 <= r2
        dist = ndi.distance_transform_edt(m)
        relief = 1.0 - dist / max(1.0, dist.max())
        relief += rng.normal(0, 0.01, (H, W)) * (dist > 0)
        planes.append(relief.astype(np.float32))
    stack = np.stack(planes)
    results = refine_boundaries_stack(stack)
    for z in range(3):
        single = refine_boundaries(stack[z])
        np.testing.assert_array_equal(results[z].labels, single.labels)
        assert results[z].num_cells == single.num_cells
        np.testing.assert_array_equal(results[z].areas, single.areas)
        np.testing.assert_allclose(
            results[z].nn_distances, single.nn_distances, rtol=1e-6
        )


def main():
    import tempfile

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    mode = sys.argv[2] if len(sys.argv) > 2 else "plane"
    tmp_root = tempfile.mkdtemp(prefix="pcis_soak_")
    for seed in range(n):
        try:
            if mode == "experiment":
                check_experiment_seed(seed, tmp_root)
            elif mode == "refine":
                check_refine_seed(seed)
            else:
                check_seed(seed)
        except Exception:
            print(f"FAIL at seed {seed} (mode={mode})", flush=True)
            raise
        if seed % 20 == 19:
            print(f"{seed + 1}/{n} ok", flush=True)
    print(f"all {n} seeds ok (mode={mode})")


if __name__ == "__main__":
    main()
