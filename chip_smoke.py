"""GPU smoke test: the system's main paths once, at the reference's size.

Runs in ONE process on one GPU and fails (non-zero exit, no result line)
on any phase failure, and before any work when JAX finds no GPU:

  0. device: name and power limit, versions, XLA_FLAGS, compile cache;
  1. experiment analysis: a seeded tree with one 4-channel acquisition
     (CY5, RFP, GFP, DAPI; two-strain 3D05+C3M10 map) and one
     single-channel acquisition, 2048² label maps, through the folder
     flows ``run_analysis`` dispatches to — checked plane by plane and
     CSV by CSV against the oracle, exactly;
  2. fused batch segmentation on [8, 2048, 2048] bench planes: every plane
     converged, plane 0 bit-equal to the oracle;
  3. refine on a [4, 2048, 2048] touching-cell stack (all converged), the
     certified-exact EDT bit-equal to scipy, and boundary IoU vs the oracle
     priority flood on the 512² bench relief (≥ 0.9977; ≥ 0.9907 at 16
     levels);
  4. NanoSIMS: one 512² acquisition, 7 isotopes, ~120 painted ROIs through
     ``run_nanosims``, against the same call on the CPU (rel ≤ 1e-6).

``--four-cards`` runs ONLY the multi-device paths (sharded full analysis,
data-parallel ``run_batch``, space-sharded refine) on four GPUs, each
compared bit for bit with the same call on one GPU.  ``--trace DIR``
also profiles a warm rerun of phases 1-3 and prints device milliseconds
per pipeline stage (utils/profiling.DEVICE_STAGES).

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--seed N] [--four-cards] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from particle_col_image_segmentation_tpu.utils.cache import enable_compile_cache

CACHE_DIR = enable_compile_cache()

import numpy as np  # noqa: E402

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "tests"))

N = 2048  # the reference's plane size (tiff_analysis.py:734)
MAX_REGIONS = 16383  # bench planes hold ~12.6k components


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last stdout line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_twice(fn):
    """(result, first-call s, warm s): the first call includes
    compilation, so first − warm is the compile (and cache-load) time."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    warm = time.perf_counter() - t0
    return out, first, warm


def report(phase: str, first: float, warm: float) -> None:
    log(f"[{phase}] wall {warm:.3f} s warm; first call {first:.3f} s "
        f"(compile ≈ {max(first - warm, 0.0):.3f} s)")


# ---------------------------------------------------------------- phase 0
def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found {dev.platform!r}, not a GPU — no result"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    import jaxlib

    log(f"nvidia-smi: {smi}")
    log(f"device_kind: {dev.device_kind}  count: {len(jax.devices())}")
    log(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    log(f"compile cache: {CACHE_DIR}")
    return dev


# ---------------------------------------------------------------- phase 1
MULTI_FOLDER = os.path.join("3D05_C3M10", "48h", "Tp_1_48h_60X_1")
MULTI_FILES = {  # channel -> label-map file, in analysis order
    "RFP": "Tp_1_48h_60X_1_RFP_labels.h5",
    "DAPI": "Tp_1_48h_60X_1_DAPI_labels.h5",
    "GFP": "Tp_1_48h_60X_1_GFP_labels.h5",
}
SINGLE_FOLDER = os.path.join("exp", "24h", "Tp_3D05_1_24h_60X_15")
SINGLE_FILE = "Tp_3D05_1_24h_60X_15_labels.h5"


def _label_plane(cell_types, seed):
    from fixtures import synthetic_label_plane

    return synthetic_label_plane(
        shape=(N, N), cell_types=cell_types, seed=seed, n_particles=6,
        n_cells_per_strain=400, n_clusters_per_strain=40,
    )


def build_tree(root: str, seed: int):
    """Seeded experiment tree.  The label maps are Ilastik .h5 files in a
    deployment; here their planes stay in memory and the .h5 names are
    empty placeholders (discovery and CSV naming read only the names).
    The CY5 capture has no label map in the reference's analysis (its
    channel set is RFP/DAPI/GFP), so it sits beside them as a raw TIFF."""
    from particle_col_image_segmentation_tpu.io.tiff import write_tiff
    from particle_col_image_segmentation_tpu.labels import classmaps

    strains = classmaps.get_strains_from_path(MULTI_FOLDER)
    planes = {}
    for k, (ch, fname) in enumerate(MULTI_FILES.items()):
        ct = classmaps.get_cell_type_map_from_channel(strains, ch)
        planes[os.path.join(root, MULTI_FOLDER, fname)] = (
            _label_plane(ct, seed + k), ct
        )
    ct = classmaps.get_cell_type_map(SINGLE_FILE)
    planes[os.path.join(root, SINGLE_FOLDER, SINGLE_FILE)] = (
        _label_plane(ct, seed + 10), ct
    )
    for path in planes:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    rng = np.random.default_rng(seed)
    write_tiff(
        os.path.join(root, MULTI_FOLDER, "Tp_1_48h_60X_1_CY5.tif"),
        rng.integers(0, 4096, (N, N), dtype=np.uint16),
    )
    return planes, strains


def run_tree(root: str, planes, cfg):
    """The run_analysis folder loop, fed from memory: every plane enters
    the folder flows as the precomputed input ``process_h5_folder`` takes
    (ds_arr, no device result), so the flows run their full device graphs
    on it."""
    from particle_col_image_segmentation_tpu.io.discovery import (
        get_h5_files_recursively,
    )
    from particle_col_image_segmentation_tpu.models import experiment
    from particle_col_image_segmentation_tpu.oracle.reference_pipeline import (
        normalize_ds_arr,
    )

    inputs = {p: (None, normalize_ds_arr(img, cfg)) for p, (img, _) in planes.items()}
    order = list(MULTI_FILES.values())  # the oracle replication's order
    results = {}
    for folder, files in sorted(get_h5_files_recursively(root).items()):
        files = sorted(files, key=lambda f: order.index(f) if f in order else 0)
        if len(files) == 1:
            results[folder] = experiment.process_single_h5_file(
                folder, files[0], cfg, make_figures=False, device_outs=inputs
            )
        else:
            results[folder] = experiment.process_multiple_h5_files(
                folder, files, cfg, make_figures=False, device_outs=inputs
            )
    return results


def phase_experiment(seed: int):
    from parity import (
        assert_analysis_parity,
        write_expected_multichannel_csvs,
        write_expected_single_csvs,
    )

    from particle_col_image_segmentation_tpu.config import AnalysisConfig

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "tree")
        planes, strains = build_tree(root, seed)
        results, first, warm = timed_twice(lambda: run_tree(root, planes, cfg))
        report("1 experiment", first, warm)

        t0 = time.perf_counter()
        multi = results[os.path.join(root, MULTI_FOLDER)]
        for ch, fname in MULTI_FILES.items():
            img, ct = planes[os.path.join(root, MULTI_FOLDER, fname)]
            assert_analysis_parity(multi[ch], img, ct, cfg, merged=False)
        img, ct = planes[os.path.join(root, SINGLE_FOLDER, SINGLE_FILE)]
        single = results[os.path.join(root, SINGLE_FOLDER)]
        assert_analysis_parity(single, img, ct, cfg, merged=True)

        exp = os.path.join(td, "expected")
        os.makedirs(os.path.join(exp, "multi"))
        os.makedirs(os.path.join(exp, "single"))
        mdir = os.path.join(root, MULTI_FOLDER)
        want = write_expected_multichannel_csvs(
            {ch: planes[os.path.join(mdir, f)][0] for ch, f in MULTI_FILES.items()},
            strains, cfg, os.path.join(exp, "multi"), "Tp_1_48h_60X_1",
        )
        got = {
            "raw": os.path.join(mdir, "Tp_1_48h_60X_1_cell_pos_raw.csv"),
            "density": os.path.join(
                mdir, "..", "3D05_C3M10_48h_cell_density_info.csv"),
            "combined": os.path.join(mdir, "Tp_1_48h_60X_1_cell_pos_combined.csv"),
            "merged": os.path.join(mdir, "Tp_1_48h_60X_1_merged_cell_pos.csv"),
        }
        sdir = os.path.join(root, SINGLE_FOLDER)
        want_s = write_expected_single_csvs(
            img, ct, cfg, os.path.join(exp, "single"), "Tp_3D05_1_24h_60X_15"
        )
        got_s = {
            "pos": os.path.join(sdir, "Tp_3D05_1_24h_60X_15_cell_pos.csv"),
            "merged": os.path.join(sdir, "Tp_3D05_1_24h_60X_15_merged_cell_pos.csv"),
            "density": os.path.join(sdir, "..", "exp_24h_cell_density_info.csv"),
        }
        for w, g in ((want, got), (want_s, got_s)):
            for key in w:
                with open(w[key]) as a, open(g[key]) as b:
                    assert a.read() == b.read(), f"CSV {g[key]} differs"
        n_regions = {ch: multi[ch].num_regions for ch in MULTI_FILES}
        n_regions["single"] = single.num_regions
        log(f"[1 experiment] oracle parity: 4 planes exact, "
            f"{len(got) + len(got_s)} CSVs byte-equal; regions {n_regions}; "
            f"oracle check {time.perf_counter() - t0:.1f} s")
    return planes


# ---------------------------------------------------------------- phase 2
def phase_fused_batch():
    import jax
    import jax.numpy as jnp

    import bench
    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.models.batch import (
        fused_segment_batch,
    )

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    batch = np.stack([bench.make_plane(s) for s in range(8)])
    x = jnp.asarray(batch)
    compiled = fused_segment_batch.lower(x, cfg).compile()
    log(f"[2 fused batch] memory_analysis: {compiled.memory_analysis()}")
    out, first, warm = timed_twice(
        lambda: jax.block_until_ready(fused_segment_batch(x, cfg))
    )
    report("2 fused batch", first, warm)
    conv = np.asarray(out[-1])
    num = np.asarray(out[1])
    assert conv.all(), f"unconverged planes: {np.nonzero(~conv)[0].tolist()}"
    assert (num <= MAX_REGIONS).all(), num
    _, oden, olab = bench.bench_reference_cpu(batch[0])
    assert bench.check_mask_parity(batch[0], oden, olab), "plane 0 != oracle"
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[2 fused batch] [8, {N}, {N}]: converged all, components "
        f"{num.tolist()}, plane 0 bit-equal to the oracle; "
        f"{8 * N * N / 1e6 / warm:.1f} MP/s warm; peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    return x, cfg


# ---------------------------------------------------------------- phase 3
def refine_stack(seed: int, z: int = 4):
    import bench

    return np.stack(
        [bench.touching_relief(N, pairs=480, seed=seed + k) for k in range(z)]
    )


def phase_refine(seed: int):
    import jax.numpy as jnp
    from scipy import ndimage as ndi

    import bench
    from particle_col_image_segmentation_tpu.config import RefineConfig
    from particle_col_image_segmentation_tpu.models.refine import (
        refine_boundaries,
        refine_boundaries_stack,
    )
    from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact_auto

    stack = refine_stack(seed)
    res, first, warm = timed_twice(lambda: refine_boundaries_stack(stack))
    report("3 refine", first, warm)  # raises if any plane is unconverged
    cells = [r.num_cells for r in res]
    assert min(cells) > 0, cells

    binary = stack[0] < RefineConfig().boundary_threshold
    got = np.asarray(edt_sq_exact_auto(jnp.asarray(~binary)))
    # scipy's float64 sqrt squared is the integer up to rounding (1e-12)
    want = ndi.distance_transform_edt(binary) ** 2
    assert np.abs(got - want).max() < 1e-6
    assert np.array_equal(got, np.round(want)), "certified-exact EDT != scipy"

    prob = bench.touching_relief(512)
    iou = bench.oracle_boundary_iou(prob, refine_boundaries(prob).labels)
    q16 = (np.round(prob * 15.0) / 15.0).astype(np.float32)
    iou_q16 = bench.oracle_boundary_iou(q16, refine_boundaries(q16).labels)
    assert iou >= 0.9977 and iou_q16 >= 0.9907, (iou, iou_q16)
    log(f"[3 refine] [4, {N}, {N}]: converged all, cells {cells}; EDT "
        f"bit-equal to scipy; boundary IoU {iou:.4f}, 16 levels "
        f"{iou_q16:.4f}")
    return stack


# ---------------------------------------------------------------- phase 4
def write_nanosims_inputs(d: str, seed: int):
    """One 512² acquisition (514² with the frame), 7 isotopes + Esi, and a
    768² painted ROI canvas with ~120 red/green ROIs (the bench config #4
    geometry) plus an aggregate-boundary stroke."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "mats"))
    for name in ("12C", "13C", "14N12C", "15N12C", "16O", "17O", "18O", "Esi"):
        savemat(os.path.join(d, "mats", f"{name}.mat"),
                {"IM": rng.poisson(40.0, (514, 514)).astype(np.float64)})
    rgb = np.full((768, 768, 3), 255, np.uint8)
    k = 0
    for gy in range(0, 768 - 48, 66):
        for gx in range(0, 768 - 48, 66):
            if k < 121:
                color = (255, 0, 0) if k % 2 == 0 else (0, 255, 0)
                rgb[gy + 4: gy + 40, gx + 4: gx + 40] = color
            k += 1
    Image.fromarray(rgb).save(os.path.join(d, "rois.png"))
    bound = np.full((768, 768, 3), 255, np.uint8)
    bound[380:384, 40:720] = (255, 0, 0)
    Image.fromarray(bound).save(os.path.join(d, "bound.png"))


def phase_nanosims(seed: int):
    import jax

    from particle_col_image_segmentation_tpu.models.nanosims import run_nanosims

    with tempfile.TemporaryDirectory() as td:
        write_nanosims_inputs(td, seed)

        def run(sub):
            out = os.path.join(td, sub)
            os.makedirs(out, exist_ok=True)
            return run_nanosims(
                os.path.join(td, "mats"), os.path.join(td, "rois.png"),
                bound_png=os.path.join(td, "bound.png"), out_dir=out,
                make_figures=False,
            )

        gpu, first, warm = timed_twice(lambda: run("gpu"))
        report("4 nanosims", first, warm)
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = run("cpu")
        n = gpu.red.num_rois + gpu.green.num_rois
        assert n >= 100, n
        worst = 0.0
        for a, b in ((gpu.all_data, cpu.all_data), (gpu.data_xy, cpu.data_xy),
                     (gpu.nearest, cpu.nearest)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
            scale = np.maximum(np.abs(b), np.finfo(np.float64).tiny)
            worst = max(worst, float(np.nanmax(np.abs(a - b) / scale)))
    log(f"[4 nanosims] {n} ROIs x 7 isotopes at 512²: GPU vs CPU max "
        f"relative error {worst:.3e} (≤ 1e-6)")


# ---------------------------------------------------------------- four cards
def phase_four_cards(seed: int):
    import jax

    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.models import analyze_plane
    from particle_col_image_segmentation_tpu.models.batch import run_batch
    from particle_col_image_segmentation_tpu.models.refine import (
        refine_boundaries_sharded,
        refine_boundaries_stack,
    )
    from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh
    from parity import assert_regions_equal

    import bench

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX found {len(devs)}")
    devs = devs[:4]
    cfg = AnalysisConfig(max_regions=MAX_REGIONS)

    # sharded full analysis (`analyze --space-parallel 4`), plane by plane
    space = make_mesh(n_data=1, n_space=4, devices=devs)
    ct = {1: "3D05", 2: "Particle", 3: "Background"}
    planes = [_label_plane(ct, seed + k) for k in range(4)]

    def sharded():
        return [analyze_plane(p, ct, cfg, merged=True, mesh=space)
                for p in planes]

    got, first, warm = timed_twice(sharded)
    report("4x analyze --space-parallel 4", first, warm)
    with jax.default_device(devs[0]):
        ref = [analyze_plane(p, ct, cfg, merged=True) for p in planes]
    for a, b in zip(got, ref):
        assert np.array_equal(a.denoised, b.denoised)
        assert np.array_equal(a.filled, b.filled)
        assert a.filled_particle_area == b.filled_particle_area
        for k in b.cell_pos:
            assert_regions_equal(a.cell_pos[k], b.cell_pos[k])
            assert_regions_equal(a.cell_clusters[k], b.cell_clusters[k])
        for k in b.merged_clusters:
            assert [g["area"] for g in a.merged_clusters[k]] == [
                g["area"] for g in b.merged_clusters[k]]
            for ga, gb in zip(a.merged_clusters[k], b.merged_clusters[k]):
                assert_regions_equal(ga["regions"], gb["regions"])
    log("[4x] sharded full analysis: 4 planes identical to one card")

    # data-parallel run_batch over 4 cards
    store = {f"plane_{k}": bench.make_plane(seed + k) for k in range(8)}
    data = make_mesh(n_data=4, n_space=1, devices=devs)

    def batch(mesh):
        return dict(run_batch(sorted(store), store.__getitem__, cfg,
                              batch_size=8, mesh=mesh, on_error="raise"))

    got_b, first, warm = timed_twice(lambda: batch(data))
    report("4x run_batch data-parallel", first, warm)
    with jax.default_device(devs[0]):
        ref_b = batch(None)
    assert sorted(got_b) == sorted(store)
    for k in store:
        a, b = got_b[k], ref_b[k]
        assert a.converged and not a.overflow, k
        assert (a.num_regions, a.particle_px, a.cell_px) == (
            b.num_regions, b.particle_px, b.cell_px), k
        assert np.array_equal(a.class_px, b.class_px), k
    log("[4x] data-parallel run_batch: 8 planes identical to one card")

    # space-sharded refine
    stack = refine_stack(seed)
    got_r, first, warm = timed_twice(
        lambda: refine_boundaries_sharded(stack, mesh=space, stack=True)
    )
    report("4x refine space=4", first, warm)
    with jax.default_device(devs[0]):
        ref_r = refine_boundaries_stack(stack)
    for a, b in zip(got_r, ref_r):
        assert np.array_equal(a.labels, b.labels)
        assert a.num_cells == b.num_cells
        assert np.array_equal(a.areas, b.areas)
        assert np.array_equal(a.centroids, b.centroids)
    log("[4x] space-sharded refine: 4 planes identical to one card")


# ---------------------------------------------------------------- trace
def copy_rate_gbps() -> float:
    """Device copy rate: read + write of a 1 GiB f32 buffer, best of 5."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    jax.block_until_ready(f(x))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        best = min(best, time.perf_counter() - t0)
    return 2 * x.nbytes / 1e9 / best


def phase_trace(trace_dir: str, hlo_dir: str, seed: int, fused_in):
    """Warm rerun of phases 1-3 under the profiler; device ms per stage."""
    import jax

    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.models.batch import (
        fused_segment_batch,
    )
    from particle_col_image_segmentation_tpu.models.refine import (
        refine_boundaries_stack,
    )
    from particle_col_image_segmentation_tpu.utils.profiling import (
        device_stage_times,
        hlo_op_stages,
    )

    log(f"[trace] device copy rate {copy_rate_gbps():.1f} GB/s "
        "(read + write, 1 GiB f32)")
    x, cfg = fused_in
    stack = refine_stack(seed)
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "tree")
        planes, _ = build_tree(root, seed)
        acfg = AnalysisConfig(max_regions=MAX_REGIONS)
        run_tree(root, planes, acfg)  # warm
        sections = {}
        for name, fn in (
            ("1 experiment", lambda: run_tree(root, planes, acfg)),
            ("2 fused batch", lambda: jax.block_until_ready(
                fused_segment_batch(x, cfg))),
            ("3 refine", lambda: refine_boundaries_stack(stack)),
        ):
            d = os.path.join(trace_dir, name.replace(" ", "_"))
            t0 = time.perf_counter()
            with jax.profiler.trace(d):
                fn()
            wall = time.perf_counter() - t0
            op_stages = hlo_op_stages(hlo_dir)
            times = device_stage_times(d, op_stages)
            times["wall"] = wall * 1e3
            sections[name] = times
            log(f"[trace] {name}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(times.items())) + " (ms)")
    with open(os.path.join(trace_dir, "stage_times.json"), "w") as f:
        json.dump(sections, f, indent=1)
    # the (module, op) → stage map, so the traces can be reduced again
    # without the (large, temporary) HLO dumps
    with open(os.path.join(trace_dir, "op_stages.json"), "w") as f:
        json.dump([[m, op, st] for (m, op), st in sorted(op_stages.items())], f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU paths, each vs one GPU")
    ap.add_argument("--trace", metavar="DIR",
                    help="also profile phases 1-3 and print device ms per "
                    "stage (writes the traces and stage_times.json to DIR)")
    args = ap.parse_args(argv)
    if args.trace:
        # XLA's optimized-HLO dumps map the trace's ops to stages; they are
        # large, so they live in a temporary directory
        hlo_dir = tempfile.mkdtemp(prefix="chip_smoke_hlo_")
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_dump_to={hlo_dir} --xla_dump_hlo_as_text"
        ).strip()

    import jax

    if args.trace:
        # executables loaded from the persistent cache skip compilation and
        # so leave no HLO dump to map their ops to stages
        jax.config.update("jax_enable_compilation_cache", False)
    dev = phase_device()
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.seed)
        count = 4
    else:
        phase_experiment(args.seed)
        fused_in = phase_fused_batch()
        phase_refine(args.seed)
        phase_nanosims(args.seed)
        if args.trace:
            try:
                phase_trace(os.path.abspath(args.trace), hlo_dir, args.seed,
                            fused_in)
            finally:
                shutil.rmtree(hlo_dir, ignore_errors=True)
        count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(result_line(dev.platform, dev.device_kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
