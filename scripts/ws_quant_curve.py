"""Watershed parity vs probability-map quantization (VERDICT r2 #4).

Ilastik exports probability maps that users often store uint8-quantized
(reference refine_boundaries.py:34,73 — the probability relief is the real
watershed input).  Quantization creates plateaus, where priority-flood pop
order (img, heap age) is hardest to model with an order-independent
fixpoint.  This script measures boundary IoU of ops.watershed vs the
oracle priority flood across quantization levels on:

  - smooth:   touching-cell EDT-derived reliefs (the realistic regime)
  - blurred:  the same after a sigma=2 gaussian (Ilastik maps are smooth)
  - noise:    an adversarial random relief (the PERF.md 0.80 case)

Markers are computed ONCE per fixture from the quantized map via the
oracle chain and fed to both watersheds, so the IoU isolates flood-order
parity.  Run: JAX_PLATFORMS=cpu python scripts/ws_quant_curve.py [n]
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
from scipy import ndimage as ndi  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particle_col_image_segmentation_tpu.oracle import ndimage as ond  # noqa: E402
from particle_col_image_segmentation_tpu.ops.watershed import watershed  # noqa: E402
from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou  # noqa: E402


def touching_cells(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(max(6, n // 17)):
        cy, cx = rng.integers(40, n - 40, 2)
        r2 = int(rng.integers(150, 400))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def fixtures(n: int):
    smooth = touching_cells(n, 0)
    yield "smooth", smooth
    yield "blurred", ndi.gaussian_filter(smooth, sigma=2.0).astype(np.float32)
    rng = np.random.default_rng(1)
    yield "noise", rng.random((n, n)).astype(np.float32)


def quantize(prob: np.ndarray, k: int) -> np.ndarray:
    if k <= 0:
        return prob
    return (np.round(prob * (k - 1)) / (k - 1)).astype(np.float32)


def one(prob: np.ndarray, k: int) -> float:
    q = quantize(prob, k)
    binary = q < 0.5
    if not binary.any():
        return float("nan")
    dist = ndi.distance_transform_edt(binary)
    markers = ond.label(ond.local_maxima(dist).astype(np.uint8))
    return _iou(q, markers, binary)


def _iou(q, markers, binary) -> float:
    dev = np.asarray(
        watershed(jnp.asarray(q), jnp.asarray(markers), jnp.asarray(binary),
                  max_iters=4096)
    )
    orc = ond.watershed(q, markers, mask=binary)
    return float(boundary_iou(dev, orc))


def one_sparse(prob: np.ndarray, k: int, seed: int = 2) -> float:
    """Sparse random seeds flooding the whole plane — the hardest regime:
    plateaus span the image, flood order is almost entirely heap-age."""
    q = quantize(prob, k)
    rng = np.random.default_rng(seed)
    markers = np.zeros(prob.shape, np.int32)
    n = prob.shape[0]
    pts = sorted(
        {(int(y), int(x)) for y, x in rng.integers(0, n, (20, 2))}
    )  # raster-ordered ids, like the marker compaction (and skimage ages)
    for i, (cy, cx) in enumerate(pts):
        markers[cy, cx] = i + 1
    return _iou(q, markers, np.ones(prob.shape, bool))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    for name, prob in fixtures(n):
        row = {"fixture": name, "n": n}
        for k in (4, 8, 16, 32, 64, 256, 0):
            iou = one(prob, k)
            row[f"k{k or 'inf'}"] = round(iou, 4)
        print(json.dumps(row), flush=True)
        row = {"fixture": name + "+sparse_seeds", "n": n}
        for k in (4, 8, 16, 32, 64, 256, 0):
            iou = one_sparse(prob, k)
            row[f"k{k or 'inf'}"] = round(iou, 4)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
