"""Wall-clock A/B of run_analysis(batch_planes=N) vs the sequential flow.

VERDICT r3 #5 / r4 #2: the batched-analyze path shipped with byte-identical
CSV tests, but the claimed chip-idle win between per-plane dispatches was
never measured.  This script builds a >=16-plane tree of synthetic 2048^2
label planes (the reference's fixed plane size, tiff_analysis.py:734) in a
temp dir and times run_analysis end-to-end (figures off, CSVs on — the real
folder flow) sequentially vs batched.

Usage: python scripts/batched_analyze_bench.py [n_planes] [plane_size]
Run ONE process at a time, so the two arms never share the device.
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests"),
)

import jax
import numpy as np

from fixtures import synthetic_label_plane
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.io.hdf5 import save_h5_plane
from particle_col_image_segmentation_tpu.models import experiment


def build_tree(root: str, n_planes: int, size: int) -> str:
    cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
    for i in range(n_planes):
        folder = os.path.join(root, "24h", f"Tp_3D05_{i}_24h_60X")
        os.makedirs(folder)
        img = synthetic_label_plane(
            seed=100 + i, cell_types=cell_types, shape=(size, size)
        )
        save_h5_plane(
            os.path.join(folder, f"Tp_3D05_{i}_24h_60X_labels.h5"), img
        )
    return os.path.join(root, "24h")


def timed_run(tree: str, cfg, batch_planes: int) -> float:
    t0 = time.perf_counter()
    experiment.run_analysis(
        tree, cfg, make_figures=False, batch_planes=batch_planes
    )
    return time.perf_counter() - t0


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    print("device:", jax.devices()[0].device_kind, "planes:", n, "size:", size,
          flush=True)
    cfg = AnalysisConfig()
    root = tempfile.mkdtemp(prefix="pcis_batch_bench_")
    try:
        tree = build_tree(root, n, size)
        mp = n * size * size / 1e6
        # warm both graph variants once (compile), then alternate
        # measured runs so host drift hits both arms equally
        for bp in (1, 8):
            dt = timed_run(tree, cfg, bp)
            print(f"warm batch_planes={bp}: {dt:.2f} s", flush=True)
        results = {}
        for rep in range(3):
            for bp in (1, 8, 16):
                dt = timed_run(tree, cfg, bp)
                results.setdefault(bp, []).append(dt)
                print(
                    f"rep {rep} batch_planes={bp:3d}: {dt:6.2f} s "
                    f"({mp / dt:6.1f} MP/s)",
                    flush=True,
                )
        base = min(results[1])
        print("\nbest-of-3:")
        for bp in sorted(results):
            best = min(results[bp])
            print(
                f"batch_planes={bp:3d}: {best:6.2f} s  {mp / best:6.1f} MP/s"
                f"  speedup x{base / best:.2f}"
            )
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
