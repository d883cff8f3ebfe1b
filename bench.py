"""Throughput benchmark: fused segmentation pass, MP/s per chip.

Metric (BASELINE.json): Megapixels/sec/chip of the full segmentation pass —
median denoise → connected components → compact labels → region properties →
particle area — on batched 2048² label planes (the reference's fixed plane
size, tiff_analysis.py:734).

vs_baseline: the reference has no published numbers (BASELINE.md), so the
baseline is the reference CPU path (scipy median_filter + oracle
CCL/regionprops on one identical plane).  The denominator is PINNED
(BASELINE.json "pinned_cpu", measured 2026-08-20 under controlled conditions)
because the live in-process measurement swung the ratio 475.7 -> 276.89
across driver records from host-load noise alone; the live measurement still
runs every bench (its mask parity check is load-bearing) and is reported as
vs_baseline_live / cpu_live_mps.

Needs a GPU: with no GPU it exits non-zero before measuring anything.
Prints ONE JSON line.
"""

import json
import os
import time
from typing import Tuple

from particle_col_image_segmentation_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np  # noqa: E402

H = W = 2048
# PCIS_BENCH_BATCH overrides for tuning runs
BATCH = int(os.environ.get("PCIS_BENCH_BATCH", "32"))
ITERS = 6
# capacity ≥ actual regions (~12.6k); table rows = 16384
MAX_REGIONS = 16383


def make_plane(seed: int) -> np.ndarray:
    """Synthetic 2048² label plane with reference-like structure."""
    rng = np.random.default_rng(seed)
    arr = np.full((H, W), 3, np.uint8)  # background
    yy, xx = np.mgrid[:256, :256]
    for _ in range(6):  # particles
        cy, cx = rng.integers(200, H - 200, 2)
        r = int(rng.integers(60, 120))
        y0, x0 = cy - 128, cx - 128
        m = (yy - 128) ** 2 + (xx - 128) ** 2 <= r * r
        arr[y0 : y0 + 256, x0 : x0 + 256][m] = 2
    for _ in range(3000):  # cells
        cy, cx = rng.integers(8, H - 8, 2)
        r = int(rng.integers(2, 5))
        sl = arr[cy - r : cy + r + 1, cx - r : cx + r + 1]
        dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
        sl[dy * dy + dx * dx <= r * r] = 1
    # speckle noise for the median filter to clean
    noise = rng.random((H, W)) < 0.01
    arr[noise] = rng.integers(1, 4, noise.sum()).astype(np.uint8)
    return arr


def bench_device(batch: np.ndarray) -> float:
    import jax
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.models.batch import fused_segment_batch

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)

    @jax.jit
    def segment_pass(imgs):
        # The scalar fingerprint depends on every pipeline stage, so one
        # scalar readback drains the whole queue — no whole-plane reduction
        # in the timed graph.
        seg, num, areas, classes, particle_px, cell_px, class_px, conv = (
            fused_segment_batch(imgs, cfg, particle_val=2, cell_vals=(1,))
        )
        return jnp.sum(num) + jnp.sum(areas) + jnp.sum(particle_px)

    x = jnp.asarray(batch)
    # warmup: compile + a few steady-state executions
    _ = int(jnp.stack([segment_pass(x) for _ in range(4)]).sum())
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        fps = [segment_pass(x) for _ in range(ITERS)]
        _ = int(jnp.stack(fps).sum())  # one scalar readback drains the queue
        best = min(best, time.perf_counter() - t0)
    mp = BATCH * H * W * ITERS / 1e6
    return mp / best


def bench_reference_cpu(plane: np.ndarray):
    """Reference path: scipy median + (skimage-equivalent) CCL + regionprops.
    Returns (MP/s, oracle denoised plane, oracle label ids)."""
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu.oracle import ndimage as ond

    best = float("inf")
    den = lab = None
    for _ in range(2):  # best-of-2 damps host scheduling noise
        t0 = time.perf_counter()
        den = ndi.median_filter(plane, size=5)
        lab = ond.label(den, background=-1)
        regions = ond.regionprops(lab)
        _ = sum(r.area for r in regions if den[r.coords[0][0], r.coords[0][1]] == 2)
        best = min(best, time.perf_counter() - t0)
    return (H * W / 1e6) / best, den, lab


def check_mask_parity(plane: np.ndarray, oracle_den, oracle_lab) -> bool:
    """Exact integer-mask parity of the device pass vs the oracle
    (the BASELINE.json accuracy contract, checked every bench run)."""
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu.utils.metrics import masks_equal

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    seg, num, *_ = fused_segment_batch(jnp.asarray(plane[None]), cfg)
    dev_seg = np.asarray(seg[0])
    return masks_equal(dev_seg, oracle_lab)


def touching_cells_mask(n: int, pairs: int, seed: int = 0) -> np.ndarray:
    """[n, n] mask of ``pairs`` touching cell pairs (two overlapping disks
    each), painted in local windows so 2048² planes build fast; the same
    draws as a full-plane paint, so a given (n, pairs, seed) is fixed."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    for _ in range(pairs):
        cy, cx = (int(v) for v in rng.integers(40, n - 40, 2))
        r2 = int(rng.integers(150, 400))
        dx = int(1.5 * np.sqrt(r2))
        y0, y1 = max(cy - 21, 0), min(cy + 22, n)
        x0, x1 = max(cx - 21, 0), min(cx + dx + 22, n)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        win = m[y0:y1, x0:x1]
        win |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        win |= (yy - cy) ** 2 + (xx - cx - dx) ** 2 <= r2
    return m


def touching_relief(n: int = 512, pairs: int = 30, seed: int = 0) -> np.ndarray:
    """Boundary-probability relief of a touching-cell mask: 1 − EDT/max
    (the BASELINE config #3 fixture at its default size)."""
    from scipy import ndimage as ndi

    dist = ndi.distance_transform_edt(touching_cells_mask(n, pairs, seed))
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def oracle_boundary_iou(prob: np.ndarray, labels: np.ndarray) -> float:
    """Boundary IoU of refine labels vs the oracle priority flood on the
    same relief (reference refine_boundaries.py:44-73 semantics)."""
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu.oracle import ndimage as ond
    from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou

    binary = prob < 0.5
    odist = ndi.distance_transform_edt(binary)
    omark = ond.label(ond.local_maxima(odist).astype(np.uint8))
    oref = ond.watershed(prob, omark, mask=binary)
    return boundary_iou(labels, oref)


def watershed_boundary_iou() -> Tuple[float, float, float]:
    """Watershed parity + refine throughput (BASELINE config #3): returns
    (boundary IoU vs the oracle priority flood on a 512² touching-particle
    relief, same after 16-level quantization — the harshest realistic
    Ilastik-export plateau regime, VERDICT r2 #4 — and refine MP/s)."""
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.models.refine import refine_boundaries

    n = 512
    prob = touching_relief(n)
    res = refine_boundaries(prob)

    # config #3 throughput: warm end-to-end refine (EDT → markers →
    # two-phase watershed) on a touching-particle STACK — all planes flood
    # in one batched device graph (BASELINE wording is "stack")
    from particle_col_image_segmentation_tpu.models.refine import (
        refine_plane_device,
    )
    from particle_col_image_segmentation_tpu.config import RefineConfig

    B = 32
    stack = jnp.asarray(np.stack(
        [np.roll(prob, 17 * b, axis=1) for b in range(B)]
    ))
    rcfg = RefineConfig()
    out = refine_plane_device(stack, rcfg, 4095)  # warm/compile
    assert bool(np.asarray(out[-1]).all())
    reps = 3
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = refine_plane_device(stack, rcfg, 4095)
        # sync on the tiny num-cells output — reading ANY output blocks on
        # the whole executable without billing a 16 MB labels transfer
        _ = np.asarray(out[2])[:1]
        best = min(best, (time.perf_counter() - t0) / reps)
    refine_mps = (B * n * n / 1e6) / best

    iou = oracle_boundary_iou(prob, res.labels)
    # 16-level quantized variant: Ilastik exports are uint8 probability
    # maps, so the real relief is plateaued; 16 levels is the harshest
    # realistic case on the measured IoU-vs-quantization curve (PERF.md)
    q16 = (np.round(prob * 15.0) / 15.0).astype(np.float32)
    res_q = refine_boundaries(q16)
    iou_q16 = oracle_boundary_iou(q16, res_q.labels)
    return iou, iou_q16, refine_mps


def bench_config1():
    """BASELINE config #1: Otsu threshold + CCL particle count on a single
    512² 16-bit plane.  Returns (MP/s single-plane latency, vs CPU)."""
    import jax
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.ops.threshold import (
        threshold_and_count,
    )

    n = 512
    rng = np.random.default_rng(1)
    img = (rng.random((n, n)) * 400).astype(np.uint16)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(40):  # bright particles above the Otsu cut
        cy, cx = rng.integers(20, n - 20, 2)
        r2 = int(rng.integers(30, 200))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000

    fn = jax.jit(lambda x: threshold_and_count(x, max_regions=4095)[2])
    x = jnp.asarray(img)
    count = int(fn(x))
    assert count > 0
    reps = 20
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        cs = [fn(x) for _ in range(reps)]
        _ = int(jnp.stack(cs).sum())
        best = min(best, (time.perf_counter() - t0) / reps)
    dev_mps = (n * n / 1e6) / best

    # compute-only budget (VERDICT r3 #1): the e2e number above pays one
    # dispatch round trip per 0.26 MP plane — per-dispatch latency, not
    # device compute.  Batch 16 planes into ONE dispatch of the batched kernel
    # family on pre-staged device data to measure what the chip itself does
    # with this workload; the gap to dev_mps is the measured dispatch tax.
    from particle_col_image_segmentation_tpu.ops.threshold import (
        threshold_and_count_batch,
    )

    Bc = 16
    xb = jnp.asarray(np.stack([np.roll(img, 7 * b, axis=1) for b in range(Bc)]))
    fnb = jax.jit(lambda v: jnp.sum(threshold_and_count_batch(v, max_regions=4095)[2]))
    _ = int(fnb(xb))
    reps_c = 10
    best_c = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        cs = [fnb(xb) for _ in range(reps_c)]
        _ = int(jnp.stack(cs).sum())
        best_c = min(best_c, (time.perf_counter() - t0) / reps_c)
    compute_mps = (Bc * n * n / 1e6) / best_c

    # CPU path: numpy otsu-equivalent + oracle CCL
    from particle_col_image_segmentation_tpu.oracle import ndimage as ond

    t0 = time.perf_counter()
    lab = ond.label((img > _cpu_otsu(img)).astype(np.uint8), background=0)
    _ = lab.max()
    cpu_mps = (n * n / 1e6) / (time.perf_counter() - t0)
    return dev_mps, dev_mps / cpu_mps, compute_mps


def _cpu_otsu(img: "np.ndarray") -> float:
    """numpy Otsu threshold (shared by the config #1/#2 CPU baselines so
    their binning semantics cannot silently diverge)."""
    counts, edges = np.histogram(img, bins=256)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(counts)
    w1 = w0[-1] - w0
    m = np.cumsum(counts * centers)
    mu0 = m / np.maximum(w0, 1e-12)
    mu1 = (m[-1] - m) / np.maximum(w1, 1e-12)
    var_b = np.where((w0 > 0) & (w1 > 0), w0 * w1 * (mu0 - mu1) ** 2, -1)
    return float(centers[np.argmax(var_b)])


def bench_config2(tmpdir: str):
    """BASELINE config #2: real z-stack TIFFs through the native codec →
    plane split → per-plane denoise + Otsu + label stats.  End-to-end MP/s
    including host decode (the loader the fake-decode scale_bench skipped).
    """
    import jax
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.io import native
    from particle_col_image_segmentation_tpu.io.tiff import read_tiff_stack
    from particle_col_image_segmentation_tpu.ops.filters import gaussian_blur
    from particle_col_image_segmentation_tpu.ops.threshold import (
        threshold_and_count_batch,
    )

    n, planes, stacks = 512, 24, 4
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:n, :n]
    paths = []
    for s in range(stacks):
        # realistic microscope-like planes: bright particles over a dim
        # noise floor (pure random noise makes Otsu split ~50/50 and hands
        # the CCL a pathological salt-and-pepper mask)
        stack = (rng.random((planes, n, n)) * 400).astype(np.uint16)
        for p in range(planes):
            for _ in range(30):
                cy, cx = rng.integers(20, n - 20, 2)
                r2 = int(rng.integers(30, 200))
                stack[p][(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000
        path = os.path.join(tmpdir, f"stack{s}_zstack.tif")
        # multi-page write via PIL (the native writer is single-page)
        from PIL import Image

        ims = [Image.fromarray(p) for p in stack]
        ims[0].save(path, save_all=True, append_images=ims[1:])
        paths.append(path)

    # one dispatch per STACK through the batched pipeline, so per-call
    # dispatch latency stays amortized
    @jax.jit
    def stack_stats(x):
        den = gaussian_blur(x.astype(jnp.float32), sigma=1.0)
        _, _, count, num, _, _ = threshold_and_count_batch(den, max_regions=4095)
        return count + num
    _ = int(jnp.sum(stack_stats(jnp.asarray(np.zeros((planes, n, n), np.uint16)))))

    t0 = time.perf_counter()
    acc = []
    npx = 0
    for path in paths:
        stack = read_tiff_stack(path)  # native codec (mmap + strip decode)
        acc.append(jnp.sum(stack_stats(jnp.asarray(stack))))
        npx += stack.size
    _ = int(jnp.stack(acc).sum())
    dt = time.perf_counter() - t0
    assert native.available()
    dev_mps = (npx / 1e6) / dt

    # compute-only budget (VERDICT r3 #1): same per-stack pipeline on
    # PRE-STAGED device-resident stacks — decode and host->device transfer
    # excluded, so this is what the chip does once bytes are resident.
    # e2e − compute attributes the gap to the host link (decode/transfer
    # split measured in scripts/stream_decompose.py, PERF.md).
    staged = [jnp.asarray(np.asarray(read_tiff_stack(p))) for p in paths]
    _ = int(jnp.sum(stack_stats(staged[0])))
    reps_c = 3
    best_c = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        accs = []
        for _ in range(reps_c):
            accs.extend(jnp.sum(stack_stats(s)) for s in staged)
        _ = int(jnp.stack(accs).sum())
        best_c = min(best_c, (time.perf_counter() - t0) / reps_c)
    compute_mps = (npx / 1e6) / best_c

    # CPU comparison: the same per-stack pipeline (TIFF decode -> gaussian
    # -> otsu -> CCL stats) via scipy + the oracle on ONE whole stack,
    # extrapolated linearly — the reference loop is embarrassingly
    # per-plane, so one stack's time is representative and keeps the bench
    # bounded.  The decode is INSIDE the timer (the device numerator pays
    # decode + transfer too; excluding it here would overstate cpu_mps).
    from scipy import ndimage as sndi

    from particle_col_image_segmentation_tpu.oracle import ndimage as ond

    t0 = time.perf_counter()
    stack_np = np.asarray(read_tiff_stack(paths[0]))
    for plane in stack_np:
        den = sndi.gaussian_filter(plane.astype(np.float32), sigma=1.0)
        lab = ond.label((den > _cpu_otsu(den)).astype(np.uint8), background=0)
        _ = np.bincount(lab.ravel())
    cpu_mps = (stack_np.size / 1e6) / (time.perf_counter() - t0)
    return dev_mps, dev_mps / cpu_mps, compute_mps


def bench_config4():
    """BASELINE config #4: NanoSIMS per-ROI isotope reduction — one painted
    acquisition (512², 7 isotopes, ~120 ROIs) through the chunked batched
    path.  Returns (ms per acquisition, ROIs/s, vs CPU)."""
    import jax
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.models.nanosims import (
        _roi_batched,
    )

    rng = np.random.default_rng(3)
    Hp = Wp = 768
    acq = 512
    labels = np.zeros((Hp, Wp), np.int32)
    k = 1
    for gy in range(0, Hp - 48, 66):
        for gx in range(0, Wp - 48, 66):
            if k > 128:
                break
            labels[gy + 4 : gy + 40, gx + 4 : gx + 40] = k
            k += 1
    n_rois = k - 1
    iso = jnp.asarray(rng.random((7, acq, acq)), jnp.float32)
    lab = jnp.asarray(labels)

    def run():
        return _roi_batched(lab, iso, 128, acq)

    r = run()
    _ = np.asarray(r[0])[:1]
    reps = 5
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = run()
        _ = np.asarray(r[0])[:1]
        best = min(best, (time.perf_counter() - t0) / reps)

    # CPU comparison: the MATLAB-shaped per-ROI loop (cubic mask resize +
    # masked isotope sums, ref .m:122-170) on 8 sample ROIs via scipy,
    # extrapolated linearly — the loop is strictly per-ROI.
    from scipy.ndimage import zoom

    iso_np = np.asarray(iso)
    sample = 8
    t0 = time.perf_counter()
    for rid in range(1, sample + 1):
        m = (labels == rid).astype(np.float32)
        resized = zoom(m, acq / Hp, order=3, grid_mode=True, mode="grid-constant")
        _ = (resized[None] * iso_np).sum(axis=(1, 2))
        solid = np.floor(resized) >= 1
        _ = np.nonzero(solid)
    cpu_per_roi = (time.perf_counter() - t0) / sample
    cpu_rois_per_s = 1.0 / cpu_per_roi
    return best * 1e3, n_rois / best, (n_rois / best) / cpu_rois_per_s


def measure_copy_gbps() -> float:
    """Effective device bandwidth context (a 2048² f32 read+write copy;
    this field lets readers normalize)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((2048, 2048), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    _ = float(jnp.sum(f(x)))
    t0 = time.perf_counter()
    accs = [jnp.sum(f(x)) for _ in range(8)]
    _ = float(sum(accs))
    dt = (time.perf_counter() - t0) / 8
    return (2 * x.nbytes / 1e9) / dt


def main():
    import tempfile

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {platform!r} — no result"
        )

    batch = np.stack([make_plane(s) for s in range(BATCH)])
    device_mps = bench_device(batch)
    live_cpu_mps, oracle_den, oracle_lab = bench_reference_cpu(batch[0])
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE.json")) as f:
            baseline_mps = json.load(f)["pinned_cpu"]["fused_segmentation_mps"]
    except (OSError, KeyError, json.JSONDecodeError):
        baseline_mps = live_cpu_mps
    parity = check_mask_parity(batch[0], oracle_den, oracle_lab)
    iou, iou_q16, refine_mps = watershed_boundary_iou()
    c1_mps, c1_vs, c1_compute = bench_config1()
    with tempfile.TemporaryDirectory() as td:
        c2_mps, c2_vs, c2_compute = bench_config2(td)
    c4_ms, c4_rois, c4_vs = bench_config4()
    configs = {
        "1_otsu_count_512_mps": round(c1_mps, 1),
        "1_vs_cpu": round(c1_vs, 1),
        # compute-only: batched single-dispatch on device-resident data —
        # the device budget with per-dispatch latency amortized
        "1_compute_mps": round(c1_compute, 1),
        "2_zstack_e2e_mps": round(c2_mps, 1),
        "2_vs_cpu": round(c2_vs, 1),
        # compute-only: pre-staged device stacks, decode+transfer excluded
        # (their budgets: scripts/stream_decompose.py, PERF.md)
        "2_compute_mps": round(c2_compute, 1),
        "3_refine_mps": round(refine_mps, 1),
        "3_boundary_iou": round(iou, 4),
        "3_boundary_iou_q16": round(iou_q16, 4),
        "4_nanosims_ms_per_acq": round(c4_ms, 2),
        "4_nanosims_rois_per_s": round(c4_rois, 0),
        "4_vs_cpu": round(c4_vs, 1),
        "5_fused_segmentation_mps": round(device_mps, 2),
    }
    record = {
        "metric": "fused_segmentation_throughput",
        "value": round(device_mps, 2),
        "unit": "MP/s/chip",
        # pinned denominator (BASELINE.json "pinned_cpu") so the ratio is
        # comparable round-over-round; _live uses this run's measurement
        "vs_baseline": round(device_mps / baseline_mps, 2),
        "vs_baseline_live": round(device_mps / live_cpu_mps, 2),
        "cpu_live_mps": round(live_cpu_mps, 2),
        "mask_exact_parity": bool(parity),
        "watershed_boundary_iou": round(iou, 4),
        "platform": platform,
        "platform_copy_gbps": round(measure_copy_gbps(), 2),
        # one number per BASELINE.json config (VERDICT r1 #2)
        "configs": configs,
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
