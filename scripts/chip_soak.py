"""GPU parity soak: many-seed oracle parity on the accelerator.

The CPU soak (soak_fuzz.py) and the unit suite validate the kernels on the
8-virtual-device CPU backend; chip_smoke.py checks the main paths once at
full size.  This script drives N random planes through the device graphs
on the GPU — median, CCL, compaction, region tables, particle fill, merge
grouping — asserting full oracle parity per seed (masks bit-equal, tables
exact, merge groups identical), plus a refine-stage sweep (certified-exact
EDT vs scipy bit-equal, local maxima bit-equal, watershed boundary IoU
≥ 0.97 on random geometry, batched refine bit-identical to single-plane).

Shapes/strain-sets are FIXED so every graph compiles once and the soak
varies content, which is what randomized parity needs (shape coverage
lives in the CPU soak).  Any mismatch prints the seed and exits 1.

Usage:  python scripts/chip_soak.py [n_seeds] [all|analysis|refine]
(default 100 seeds, all)
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu.config import (
    AnalysisConfig,
    RefineConfig,
)
from fixtures import synthetic_label_plane

STRAIN_SETS = [
    {1: "3D05", 2: "Particle", 3: "Background"},
    {1: "3D05", 2: "6B07", 3: "C3M10", 4: "Particle", 5: "Background"},
]
SHAPE = (256, 256)
CFG = AnalysisConfig(max_regions=4096)


def check_analysis_seed(seed: int) -> None:
    from parity import assert_plane_parity

    cell_types = STRAIN_SETS[seed % len(STRAIN_SETS)]
    img = synthetic_label_plane(seed=seed, cell_types=cell_types, shape=SHAPE)
    assert_plane_parity(img, cell_types, CFG)


def _relief(seed: int, H: int = 128, W: int = 256):
    rng = np.random.default_rng(40_000 + seed)
    yy, xx = np.mgrid[:H, :W]
    m = np.zeros((H, W), bool)
    for _ in range(int(rng.integers(3, 8))):
        cy, cx = rng.integers(14, H - 14), rng.integers(14, W - 14)
        r2 = int(rng.integers(60, 170))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.4 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    relief = 1.0 - dist / max(1.0, dist.max())
    relief += rng.normal(0, 0.01, (H, W)) * (dist > 0)
    return relief.astype(np.float32), m


def check_refine_seed(seed: int, ious: list) -> None:
    from particle_col_image_segmentation_tpu.models.refine import (
        refine_plane_device,
    )
    from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact_auto
    from particle_col_image_segmentation_tpu.ops.morphology import (
        local_maxima,
    )
    from particle_col_image_segmentation_tpu.oracle import ndimage as ond
    from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou

    cfg = RefineConfig()
    planes = [_relief(4 * seed + k)[0] for k in range(4)]
    stack = jnp.asarray(np.stack(planes))
    labels_b, _, num_b, _, _, conv_b = refine_plane_device(stack, cfg, 4096)
    assert bool(np.asarray(conv_b).all()), f"unconverged at seed {seed}"
    labels_b = np.asarray(labels_b)
    for k, prob in enumerate(planes):
        binary = prob < cfg.boundary_threshold
        # certified-exact EDT: bit-equal to scipy at any depth
        dsq = np.asarray(edt_sq_exact_auto(jnp.asarray(~binary)))
        ref_d2 = np.round(ndi.distance_transform_edt(binary) ** 2)
        np.testing.assert_array_equal(dsq, ref_d2)
        # plateau-aware maxima: bit-equal to the oracle
        mx = np.asarray(local_maxima(jnp.asarray(dsq.astype(np.int32))))
        np.testing.assert_array_equal(
            mx.astype(bool), ond.local_maxima(dsq)
        )
        # batched refine bit-identical to the single-plane graph
        l1, _, n1, _, _, c1 = refine_plane_device(jnp.asarray(prob), cfg, 4096)
        assert bool(c1)
        np.testing.assert_array_equal(labels_b[k], np.asarray(l1))
        # pipeline-regime watershed parity contract
        omark = ond.label(ond.local_maxima(ref_d2).astype(np.uint8))
        oref = ond.watershed(prob, omark, mask=binary)
        iou = boundary_iou(labels_b[k], oref)
        ious.append(iou)
        # Random reliefs probe the full heap-order residual (PERF.md
        # "Watershed IoU vs quantization"): near-tie ridge pixels resolve
        # by heap age in the oracle, which no order-independent key can
        # express.  The ≥0.99 contract is measured on the pipeline/bench
        # fixtures; the soak floor bounds the residual across random
        # geometry (observed min 0.982 over the first 100-plane run).
        assert iou >= 0.97, f"seed {seed} plane {k}: boundary IoU {iou:.4f}"


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    mode = sys.argv[2] if len(sys.argv) > 2 else "all"
    dev = jax.devices()[0]
    print("device:", dev.platform, dev.device_kind, flush=True)
    t0 = time.time()
    if mode in ("all", "analysis"):
        for seed in range(n):
            try:
                check_analysis_seed(seed)
            except Exception:
                print(f"ANALYSIS FAIL at seed {seed}", flush=True)
                raise
            if seed % 10 == 9:
                print(f"analysis {seed + 1}/{n} ok "
                      f"({time.time() - t0:.0f}s)", flush=True)
    n_ref = max(1, n // 4)  # 4 planes per refine seed → n planes total
    ious: list = []
    if mode in ("all", "refine"):
        for seed in range(n_ref):
            try:
                check_refine_seed(seed, ious)
            except Exception:
                print(f"REFINE FAIL at seed {seed}", flush=True)
                raise
            if seed % 5 == 4:
                print(f"refine {seed + 1}/{n_ref} ok "
                      f"({time.time() - t0:.0f}s)", flush=True)
        a = np.asarray(ious)
        print(
            f"refine watershed boundary IoU over {a.size} planes: "
            f"min {a.min():.4f}  mean {a.mean():.4f}  "
            f"p10 {np.percentile(a, 10):.4f}  "
            f"frac>=0.99 {(a >= 0.99).mean():.2f}",
            flush=True,
        )
    print(
        f"CHIP SOAK PASS ({mode}): {n} analysis planes + "
        f"{n_ref * 4 if mode != 'analysis' else 0} refine planes, "
        f"zero exact-parity mismatches, device={dev.device_kind}, "
        f"{time.time() - t0:.0f}s"
    )


if __name__ == "__main__":
    main()
