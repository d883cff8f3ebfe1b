"""NanoSIMS 5-isotope ROI activity/distance analysis.

JAX port of HCN_nanosims_rois_activity_distance_5iso_YG.m (346 LoC
MATLAB; line references below are into that script):

  1. load per-species count images from .mat, crop a 1-px frame (:6-28);
  2. display / ratio images with Gaussian blur (:30-69);
  3. painted-PNG ROI ingestion — red/green classes (:82-102);
  4. per-ROI isotope sums and activities (:104-234) — on device, chunks of ROI
     masks resize in one vmapped call and all isotope sums reduce in one
     batched broadcast multiply-reduce per chunk (``_roi_batched``; a dot
     was tried and rejected — see the inline note there), replacing the
     MATLAB per-ROI O(ROIs·H·W) loop; a sequential ``lax.scan`` reference
     path (``_roi_scan``) remains for A/B parity tests;
  5. data.csv / data_xy.csv (:237, :252-256);
  6. nearest-neighbor distances between classes (:259-268);
  7. distance to the painted aggregate boundary (:270-309).

Deliberate deviations (each documented inline, compat-flagged where output
changes): the green-loop O17/O18 activity-image accumulation into the *red*
images (:210-213) is fixed by default (``NanoSIMSConfig.compat_green_o_bug``
restores it); boundary distances use a consistent coordinate space by
default (the MATLAB script mixes painted-space (row,col) boundary pixels
with acquisition-space (x,y) centroids, :301-304).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from particle_col_image_segmentation_tpu.config import NanoSIMSConfig
from particle_col_image_segmentation_tpu.ops import (
    boundary_mask,
    compact_labels,
    connected_components,
    gaussian_blur,
)
from particle_col_image_segmentation_tpu.ops.pairwise import min_dist_to_set

ISOTOPES = ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18", "ESI")
# data row column order (ref :154): class, i, C12, C13, N14, N15, O16, O17, O18
_SUM_ORDER = ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18")


def crop_frame(arr: np.ndarray) -> np.ndarray:
    """Crop the 1-px acquisition frame: IM(2:n-1, 2:n-1) (ref :19-28)."""
    return np.asarray(arr)[1:-1, 1:-1]


def load_isotope_mats(folder: str) -> Dict[str, np.ndarray]:
    """Load {name}.mat files, each holding matrix ``IM`` (ref :6-16), and
    crop the frame.  File naming: 12C.mat, 13C.mat, 14N12C.mat, 15N12C.mat,
    16O.mat, 17O.mat, 18O.mat, Esi.mat."""
    import os

    from scipy.io import loadmat

    names = {
        "N14C12": "14N12C.mat",
        "N15C12": "15N12C.mat",
        "C12": "12C.mat",
        "C13": "13C.mat",
        "O16": "16O.mat",
        "O17": "17O.mat",
        "O18": "18O.mat",
        "ESI": "Esi.mat",
    }
    out = {}
    for key, fname in names.items():
        out[key] = crop_frame(loadmat(os.path.join(folder, fname))["IM"].astype(np.float64))
    # deuterium-labeling variant (the .m script carries it commented out,
    # :13-14/:26-27): load 1H/2H when the acquisition includes them —
    # analyze_roi_class then also reports the D activity 2H/(1H+2H)
    for key, fname in (("H1", "1H.mat"), ("H2", "2H.mat")):
        path = os.path.join(folder, fname)
        if os.path.exists(path):
            out[key] = crop_frame(loadmat(path)["IM"].astype(np.float64))
    return out


def to_uint8_display(raw: np.ndarray) -> np.ndarray:
    """uint8(raw * 255/max) with MATLAB rounding+saturation (ref :30-39).

    MATLAB parity points: uint8() rounds half AWAY from zero (np.round is
    half-to-even — off by one at exact .5), max() ignores NaN, and
    uint8(NaN) = 0 (numpy's float→uint8 NaN cast is undefined behavior)."""
    raw = np.asarray(raw, np.float64)
    m = float(np.nanmax(raw)) if raw.size else 0.0
    scaled = raw * (255.0 / m) if m > 0 else np.zeros_like(raw)
    out = np.clip(np.floor(scaled + 0.5), 0, 255)
    return np.where(np.isnan(out), 0, out).astype(np.uint8)


def ratio_image(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """uint8(num/den * 255/max(num/den)) (ref :45-69).  0/0 pixels are NaN
    → 0 and x/0 is +Inf → NaN under the ∞-max scaling → 0, as MATLAB's
    uint8() defines them."""
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.asarray(num, np.float64) / np.asarray(den, np.float64)
    return to_uint8_display(ratio)


def display_images(iso: Dict[str, np.ndarray], cfg: NanoSIMSConfig = NanoSIMSConfig()):
    """All display/ratio images of ref :30-69 (blurred + unblurred)."""
    g = lambda a, s: np.asarray(gaussian_blur(jnp.asarray(a), s))  # noqa: E731
    n15g = g(iso["N15C12"], cfg.sigma_display)
    n14g = g(iso["N14C12"], cfg.sigma_display)
    c12g = g(iso["C12"], cfg.sigma_ratio)
    c13g = g(iso["C13"], cfg.sigma_ratio)
    o16g = g(iso["O16"], cfg.sigma_display)
    o17g = g(iso["O17"], cfg.sigma_display)
    o18g = g(iso["O18"], cfg.sigma_display)
    esig = g(iso["ESI"], cfg.sigma_ratio)
    out = {name: to_uint8_display(iso[name]) for name in _SUM_ORDER}
    out.update(
        N15ratioimg=ratio_image(n15g, n15g + n14g),
        N14C12C12ratio=ratio_image(n14g, c12g),
        C13ratioimg=ratio_image(c13g, c13g + c12g),
        O17ratioimg=ratio_image(o17g, o18g + o17g + o16g),
        O18ratioimg=ratio_image(o18g, o18g + o17g + o16g),
        # ref :63-64 computes the blurred ESI ratio then immediately
        # overwrites it with the raw one; both are exposed.
        N14C12ESIratio_blur=ratio_image(n14g, esig),
        N14C12ESIratio=ratio_image(iso["N14C12"], iso["ESI"]),
        N15ratimg=ratio_image(iso["N15C12"], iso["N15C12"] + iso["N14C12"]),
        C13ratimg=ratio_image(iso["C13"], iso["C13"] + iso["C12"]),
        O17ratimg=ratio_image(iso["O17"], iso["O18"] + iso["O17"] + iso["O16"]),
        O18ratimg=ratio_image(iso["O18"], iso["O18"] + iso["O17"] + iso["O16"]),
    )
    return out


# ---------------------------------------------------------------------------
# painted-ROI ingestion (ref :82-102)
# ---------------------------------------------------------------------------


def crop_to_content(
    rgb: np.ndarray, blue_thresh: int = 200, imcrop_rect: bool = False
) -> np.ndarray:
    """Crop a painted PNG to the bounding box of its content mask
    (blue < thresh) (ref :83-85).

    Deviation: MATLAB's imcrop(rect from regionprops BoundingBox) includes
    one extra row/col past the content extent from its half-pixel rect
    convention (rect spans [c−0.5, c+w−0.5]; imcrop keeps round(w)+1
    columns, clamped at the image edge); default crops exactly to the
    content bounding box.  ``imcrop_rect=True``
    (NanoSIMSConfig.compat_imcrop_rect) reproduces the MATLAB crop.
    """
    mask = rgb[..., 2] < blue_thresh
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return rgb
    extra = 1 if imcrop_rect else 0
    return rgb[
        ys.min() : min(ys.max() + 1 + extra, rgb.shape[0]),
        xs.min() : min(xs.max() + 1 + extra, rgb.shape[1]),
    ]


def class_masks(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """red = (R−B)==255, green = (G−B)==255 with uint8 saturating subtraction
    (ref :91-99)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    red = np.clip(r - b, 0, 255) == 255
    green = np.clip(g - b, 0, 255) == 255
    return red, green


def boundary_class_mask(rgb: np.ndarray, thresh: int = 175) -> np.ndarray:
    """bound.png red mask: (R−B) > thresh (ref :279-281)."""
    r = rgb[..., 0].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return np.clip(r - b, 0, 255) > thresh


# ---------------------------------------------------------------------------
# per-ROI reductions (ref :104-234) — one lax.scan over ROIs
# ---------------------------------------------------------------------------


def _resize_acq(mask: jnp.ndarray, out_size: int) -> jnp.ndarray:
    """MATLAB imresize bicubic+antialias ≈ jax.image.resize 'cubic',
    antialias=True (ref .m:123-125)."""
    return jax.image.resize(
        mask, (out_size, out_size), method="cubic", antialias=True
    )


# A ROI's interior resizes to exactly 1 in exact arithmetic, but the float32
# weighted sum lands a few ulp either side of 1 depending on the device's
# summation order, so a bare floor(v) >= 1 (ref .m:164-165) splits interior
# pixels differently on a GPU and a CPU.  Values within this tolerance of 1
# count as 1: far above float32 rounding (~1e-7), far below any partial
# edge coverage the resize produces.
_SOLID_TOL = 1e-5


def _solid(resized: jnp.ndarray) -> jnp.ndarray:
    """Pixels whose resized value floors to 1 (ROI solid mask)."""
    return resized >= 1.0 - _SOLID_TOL


@partial(jax.jit, static_argnames=("num_rois", "out_size", "chunk"))
@jax.named_scope("roi")
def _roi_batched(
    labels: jnp.ndarray, isotopes: jnp.ndarray, num_rois: int, out_size: int,
    chunk: int = 16,
):
    """Per-ROI isotope sums + centroids for ALL ROIs, ``chunk`` at a time.

    Replaces the reference's one-ROI-per-iteration loop (ref .m:122-170):
    per chunk, the ROI one-hot masks resize in one vmapped call (the same
    ``_resize_acq`` op as the sequential path, so the resized values — and
    therefore the solid masks — are bit-identical), isotope sums reduce in
    one batched broadcast multiply-reduce over the SAME resized masks (a
    dot contraction was deliberately rejected — see the inline note at the
    sum site), and the solid-mask centroids (MATLAB
    regionprops-on-a-double semantics: pixels whose resized value floors
    to 1, ref .m:164-165, 1-based (x, y)) reduce from the same buffers.

    A hand-rolled resize as explicit weight matrices (``A M Bᵀ`` einsum)
    was tried and dropped for its compile time on the 3-operand
    contraction; the vmapped resize compiles in normal time and still
    beats the sequential scan.  Neither path has a float matmul, so no
    reduced-precision (TF32) contraction can enter the ROI sums.

    ``num_rois`` is static — callers round it up to a bucket (see
    analyze_roi_class) so varying ROI counts reuse one compiled graph;
    padded ids have empty masks → zero sum rows / (1, 1) centroids, sliced
    off by the caller.

    Returns (sums [num_rois, n_iso], centroids_xy [num_rois, 2]).
    """
    Hs = Ws = out_size
    rows = jax.lax.broadcasted_iota(jnp.float32, (Hs, Ws), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (Hs, Ws), 1)

    def one_chunk(idvec):
        masks = (labels[None] == idvec[:, None, None]).astype(jnp.float32)
        resized = jax.vmap(lambda m: _resize_acq(m, out_size))(masks)
        # broadcast multiply-reduce, not a dot: the [chunk, n_iso, HW]
        # contraction's extreme shape (tiny M·N, huge K) compiled slowly,
        # and at ~30 MFLOP the elementwise reduction is cheap anyway; it
        # also keeps the sums in exact float32 (no TF32 matmul)
        sums = jnp.sum(resized[:, None] * isotopes[None], axis=(-2, -1))
        solid = _solid(resized)
        cnt = jnp.sum(solid, axis=(1, 2))
        # a real ROI whose antialias-downscale dissolves (no pixel >= 1)
        # has no centroid: NaN, not a silent (1,1) corner coordinate
        # (MATLAB's regionprops on the empty solid mask errors loudly)
        safe = jnp.maximum(cnt, 1)
        cx = jnp.sum(jnp.where(solid, cols[None], 0.0), axis=(1, 2)) / safe + 1.0
        cy = jnp.sum(jnp.where(solid, rows[None], 0.0), axis=(1, 2)) / safe + 1.0
        nan = jnp.float32(jnp.nan)
        cx = jnp.where(cnt > 0, cx, nan)
        cy = jnp.where(cnt > 0, cy, nan)
        return sums, jnp.stack([cx, cy], axis=-1)

    ids = jnp.arange(1, num_rois + 1).reshape(-1, chunk)
    sums, cents = jax.lax.map(one_chunk, ids)
    n_iso = isotopes.shape[0]
    return sums.reshape(num_rois, n_iso), cents.reshape(num_rois, 2)


@partial(jax.jit, static_argnames=("num_rois", "out_size"))
def _roi_scan(labels: jnp.ndarray, isotopes: jnp.ndarray, num_rois: int, out_size: int):
    """Sequential per-ROI reference path (the literal MATLAB loop shape,
    ref .m:122-170).  Kept for A/B parity tests and benchmarks against the
    batched adjoint/chunked path above — production calls use those.
    """
    n_iso = isotopes.shape[0]
    Hs, Ws = out_size, out_size
    rows = jax.lax.broadcasted_iota(jnp.float32, (Hs, Ws), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (Hs, Ws), 1)

    def body(_, i):
        mask = (labels == i).astype(jnp.float32)
        resized = _resize_acq(mask, out_size)
        sums = jnp.sum(isotopes * resized[None], axis=(1, 2))
        solid = _solid(resized)
        cnt = jnp.sum(solid)
        safe = jnp.maximum(cnt, 1)  # dissolved ROI -> NaN (see one_chunk)
        cx = jnp.sum(jnp.where(solid, cols, 0.0)) / safe + 1.0
        cy = jnp.sum(jnp.where(solid, rows, 0.0)) / safe + 1.0
        nan = jnp.float32(jnp.nan)
        return None, (sums, jnp.stack([
            jnp.where(cnt > 0, cx, nan), jnp.where(cnt > 0, cy, nan)
        ]))

    _, (sums, cents) = jax.lax.scan(
        body, None, jnp.arange(1, num_rois + 1), length=num_rois
    )
    return sums.reshape(num_rois, n_iso), cents.reshape(num_rois, 2)


@dataclasses.dataclass
class RoiClassResult:
    num_rois: int
    sums: np.ndarray  # [R, 7] per _SUM_ORDER
    activities: np.ndarray  # [R, 4]: C13act, N15act, O17act, O18act
    positions: np.ndarray  # [R, 2] (x, y), acquisition space, 1-based
    labels: np.ndarray  # painted-space ROI label image
    activity_images: Dict[str, np.ndarray]  # painted-space act maps (N/C/O17/O18)
    # deuterium variant (only when 1H/2H images are present): [R, 2] H sums
    # and [R] D activity = 2H/(1H+2H)
    h_sums: Optional[np.ndarray] = None
    d_activity: Optional[np.ndarray] = None


def analyze_roi_class(
    mask: np.ndarray,
    isotopes: Dict[str, np.ndarray],
    cfg: NanoSIMSConfig = NanoSIMSConfig(),
) -> RoiClassResult:
    """Per-ROI sums, activities, positions, and activity maps for one painted
    class (the body of ref loops :122-170 / :186-234)."""
    acq = next(iter(isotopes.values())).shape[0]
    # Label the TRANSPOSED mask so compact ids follow COLUMN-major first-
    # pixel order — MATLAB regionprops/bwconncomp numbering (the .m script's
    # per-ROI loop index and every CSV row order).  8-connectivity is
    # transpose-symmetric, so components are identical.
    rawT = connected_components(
        jnp.asarray(np.asarray(mask).T, jnp.uint8), background=0, num_classes=2
    )
    labelsT, num = compact_labels(rawT, cfg.max_rois)
    labels = jnp.swapaxes(labelsT, 0, 1)
    n = int(num)
    if n > cfg.max_rois:
        raise ValueError(f"{n} ROIs > max_rois={cfg.max_rois}")
    with_h = "H1" in isotopes and "H2" in isotopes
    keys = _SUM_ORDER + (("H1", "H2") if with_h else ())
    iso_stack = jnp.asarray(np.stack([isotopes[k] for k in keys]), jnp.float32)
    if n == 0:
        return RoiClassResult(
            0, np.zeros((0, 7)), np.zeros((0, 4)), np.zeros((0, 2)),
            np.asarray(labels), {k: np.zeros(mask.shape) for k in ("N", "C", "O17", "O18")},
            h_sums=np.zeros((0, 2)) if with_h else None,
            d_activity=np.zeros((0,)) if with_h else None,
        )
    # round the bucket up so varying ROI counts reuse one compiled graph;
    # padded ids have empty masks → zero/degenerate rows, sliced off
    bucket = max(16, 1 << (n - 1).bit_length())
    sums, cents = _roi_batched(labels, iso_stack, bucket, acq)
    sums = np.asarray(sums, np.float64)[:n]
    cents = np.asarray(cents)[:n]
    h_sums = d_activity = None
    if with_h:
        h_sums = sums[:, 7:9]
        with np.errstate(invalid="ignore", divide="ignore"):
            d_activity = h_sums[:, 1] / (h_sums[:, 0] + h_sums[:, 1])
        sums = sums[:, :7]
    c12, c13, n14, n15, o16, o17, o18 = (sums[:, i] for i in range(7))
    with np.errstate(invalid="ignore", divide="ignore"):
        acts = np.stack(
            [
                c13 / (c13 + c12),
                n15 / (n14 + n15),
                o17 / (o18 + o17 + o16),
                o18 / (o18 + o17 + o16),
            ],
            axis=1,
        )
    lab_np = np.asarray(labels)
    act_imgs = {}
    for name, col in zip(("C", "N", "O17", "O18"), range(4)):
        per_roi = np.concatenate([[0.0], acts[:, col]])
        act_imgs[name] = per_roi[np.clip(lab_np, 0, n)]
    return RoiClassResult(
        num_rois=n,
        sums=sums,
        activities=acts,
        positions=np.asarray(cents, np.float64),
        labels=lab_np,
        activity_images=act_imgs,
        h_sums=h_sums,
        d_activity=d_activity,
    )


@dataclasses.dataclass
class NanoSIMSResult:
    red: RoiClassResult
    green: RoiClassResult
    all_data: np.ndarray  # [R_red+R_green, 17] (ref :154/:218 row layout)
    data_xy: np.ndarray  # all_data + (x, y)
    nearest: Optional[np.ndarray]  # µm-converted nearest-other-class distance
    activity_images: Dict[str, np.ndarray]  # combined red+green act maps
    # the content-cropped painted ROI image the analysis actually ran on
    # (ref .m:83-85 imcrop) — reused by figure export so the crop happens
    # (and threads cfg.compat_imcrop_rect) exactly once
    rois_cropped: Optional[np.ndarray] = None


def _data_rows(cls_id: int, res: RoiClassResult) -> np.ndarray:
    n = res.num_rois
    if n == 0:
        return np.zeros((0, 17))
    idx = np.arange(1, n + 1, dtype=np.float64)
    return np.column_stack(
        [np.full(n, cls_id, np.float64), idx, res.sums, res.activities,
         res.activities * 100.0]
    )


def analyze_nanosims(
    isotopes: Dict[str, np.ndarray],
    rois_rgb: np.ndarray,
    cfg: NanoSIMSConfig = NanoSIMSConfig(),
) -> NanoSIMSResult:
    """Full ROI workflow of ref :82-268 (excluding figure export)."""
    rois = crop_to_content(rois_rgb, imcrop_rect=cfg.compat_imcrop_rect)
    red_mask, green_mask = class_masks(rois)
    red = analyze_roi_class(red_mask, isotopes, cfg)
    green = analyze_roi_class(green_mask, isotopes, cfg)

    all_data = np.vstack([_data_rows(1, red), _data_rows(2, green)])
    xy = np.vstack([red.positions, green.positions])
    data_xy = np.column_stack([all_data, xy]) if len(all_data) else np.zeros((0, 19))

    nearest = None
    if red.num_rois and green.num_rois:
        a = jnp.asarray(red.positions, jnp.float32)
        b = jnp.asarray(green.positions, jnp.float32)
        a_near = np.asarray(min_dist_to_set(a, b, jnp.ones((green.num_rois,), bool)))
        b_near = np.asarray(min_dist_to_set(b, a, jnp.ones((red.num_rois,), bool)))
        # ref :265-268: µm conversion hardcodes 512 px regardless of size
        nearest = np.concatenate([a_near, b_near]) / (
            cfg.distance_size_px / cfg.raster_um
        )
    elif red.num_rois or green.num_rois:
        # one painted class only: there IS no other-class neighbor — NaN
        # per ROI keeps data_dist_nearest.csv written and the bound CSV at
        # its documented 19 columns instead of silently shifting layouts
        nearest = np.full((red.num_rois + green.num_rois,), np.nan)

    if cfg.compat_green_o_bug:
        # ref :210-213: the green loop accumulates its O17/O18 maps into the
        # RED images (copy-paste bug).  The combined maps below are unchanged;
        # only the per-class maps move.
        for name in ("O17", "O18"):
            red.activity_images[name] = (
                red.activity_images[name] + green.activity_images[name]
            )
            green.activity_images[name] = np.zeros_like(green.activity_images[name])
    act_imgs = {
        name: red.activity_images[name] + green.activity_images[name]
        for name in ("N", "C", "O17", "O18")
    }
    return NanoSIMSResult(
        red=red, green=green, all_data=all_data, data_xy=data_xy,
        nearest=nearest, activity_images=act_imgs, rois_cropped=rois,
    )


def run_nanosims(
    mat_folder: str,
    rois_png: str,
    bound_png: Optional[str] = None,
    out_dir: str = ".",
    cfg: NanoSIMSConfig = NanoSIMSConfig(),
    make_figures: bool = True,
) -> NanoSIMSResult:
    """End-to-end NanoSIMS driver: load .mat images + painted PNGs, write
    data.csv / data_xy.csv / data_dist_nearest.csv / data_dist_nearest_bound.csv
    (ref :237,:256,:268,:309) plus the reference's figure exports
    (rois_clear / annotations / cell position / agg_boundary)."""
    import os

    from PIL import Image

    from particle_col_image_segmentation_tpu.report.csvio import write_matrix_csv

    isotopes = load_isotope_mats(mat_folder)
    rois_rgb = np.asarray(Image.open(rois_png).convert("RGB"))
    result = analyze_nanosims(isotopes, rois_rgb, cfg)
    write_matrix_csv(os.path.join(out_dir, "data.csv"), result.all_data)
    write_matrix_csv(os.path.join(out_dir, "data_xy.csv"), result.data_xy)
    if result.red.h_sums is not None:
        # deuterium variant rows: class, i, 1H, 2H, Dact, Dact·100 — an
        # ADDITIVE sidecar so the 5-isotope data.csv contract is unchanged
        d_rows = []
        for cls_id, res in ((1, result.red), (2, result.green)):
            for i in range(res.num_rois):
                d_rows.append([
                    cls_id, i + 1, res.h_sums[i, 0], res.h_sums[i, 1],
                    res.d_activity[i], res.d_activity[i] * 100.0,
                ])
        write_matrix_csv(
            os.path.join(out_dir, "data_deuterium.csv"),
            np.asarray(d_rows, np.float64).reshape(-1, 6),
        )
    if result.nearest is not None:
        write_matrix_csv(
            os.path.join(out_dir, "data_dist_nearest.csv"),
            np.column_stack([result.all_data, result.nearest]),
        )
    bound_mask_img = None
    bound_rgb_cropped = None
    if bound_png is not None:
        bound_rgb = np.asarray(Image.open(bound_png).convert("RGB"))
        acq = next(iter(isotopes.values())).shape[0]
        bound_rgb_cropped = crop_to_content(
            bound_rgb, imcrop_rect=cfg.compat_imcrop_rect
        )
        # ONE mask for both the distances and the figure export, so a
        # future threshold change cannot make them disagree silently
        bound_mask_img = boundary_class_mask(bound_rgb_cropped)
        bd = boundary_distances(
            result, bound_rgb_cropped, acq, cfg, bound_mask=bound_mask_img
        )
        base = (
            np.column_stack([result.all_data, result.nearest])
            if result.nearest is not None
            else result.all_data
        )
        write_matrix_csv(
            os.path.join(out_dir, "data_dist_nearest_bound.csv"),
            np.column_stack([base, bd]),
        )
    if make_figures:
        from particle_col_image_segmentation_tpu.viz.nanosims_figures import save_all

        save_all(
            result,
            result.rois_cropped,
            to_uint8_display(isotopes["N14C12"]),
            out_dir,
            bound_mask=bound_mask_img,
            bound_rgb=bound_rgb_cropped,
        )
    return result


def boundary_distances(
    result: NanoSIMSResult,
    bound_rgb_cropped: np.ndarray,
    acquisition_size: int,
    cfg: NanoSIMSConfig = NanoSIMSConfig(),
    bound_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Min distance from each ROI to the painted aggregate boundary, µm
    (ref :270-309).

    Deviation (documented): the MATLAB script compares acquisition-space
    (x, y) centroids against painted-space (row, col) boundary pixels
    (coordinate spaces AND axis order crossed).  We map boundary pixels to
    acquisition coordinates with the same half-pixel scaling imresize uses
    and compare consistent (x, y) pairs.

    Args:
      bound_rgb_cropped: the painted boundary image ALREADY content-cropped
        via ``crop_to_content(..., imcrop_rect=cfg.compat_imcrop_rect)`` —
        the caller crops once and reuses the array for figure export, so
        analysis and rendering cannot diverge on the compat flag.
      acquisition_size: side of the cropped isotope planes (n−2).
    """
    red = bound_mask if bound_mask is not None else boundary_class_mask(
        bound_rgb_cropped
    )
    bd = np.asarray(boundary_mask(jnp.asarray(red)))
    ys, xs = np.nonzero(bd)
    if len(ys) == 0:
        n_all = result.red.num_rois + result.green.num_rois
        return np.full((n_all,), np.inf)
    hp, wp = red.shape
    sy = acquisition_size / hp
    sx = acquisition_size / wp
    # half-pixel-center mapping into acquisition space, then 1-based like the
    # ROI centroids
    x_acq = (xs + 0.5) * sx - 0.5 + 1.0
    y_acq = (ys + 0.5) * sy - 0.5 + 1.0
    pts = np.stack([x_acq, y_acq], axis=1)
    all_pos = np.vstack([result.red.positions, result.green.positions])
    dmin = np.asarray(
        min_dist_to_set(
            jnp.asarray(all_pos, jnp.float32),
            jnp.asarray(pts, jnp.float32),
            jnp.ones((pts.shape[0],), bool),
        )
    )
    return dmin / (cfg.distance_size_px / cfg.raster_um)
