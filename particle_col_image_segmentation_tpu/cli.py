"""Command-line interface.

The reference's "CLI" is edit-the-constants scripts with hardcoded paths
(tiff_analysis.py:62, split_zstack.py:92-97, create_file_structure.py:90-94).
Here: proper subcommands with the reference constants as defaults.

  analyze    — recursive .h5 analysis (tiff_analysis.main parity)
  split      — z-stack → per-plane per-channel TIFFs (split_zstack parity)
  normalize  — raw-capture folder normalization (create_file_structure parity)
  refine     — watershed boundary refinement (refine_boundaries parity)
  nanosims   — 5-isotope ROI activity/distance analysis (.m parity)
  batch      — streaming fused segmentation stats at scale (mesh + manifest)
  bench      — run the throughput benchmark
"""

from __future__ import annotations

import argparse
import os
import sys

from particle_col_image_segmentation_tpu.utils.cache import enable_compile_cache

# Persistent XLA compile cache: the fixpoint kernels are compile-heavy; cache
# them across CLI invocations.
enable_compile_cache()

from particle_col_image_segmentation_tpu.config import AnalysisConfig, RefineConfig  # noqa: E402


def _add_analysis_flags(p: argparse.ArgumentParser) -> None:
    d = AnalysisConfig()
    p.add_argument("--denoise-size", type=int, default=d.denoise_size)
    p.add_argument("--dilation-radius", type=int, default=d.dilation_radius)
    p.add_argument("--distance-threshold", type=int, default=d.distance_threshold)
    p.add_argument(
        "--cell-cluster-distance-threshold",
        type=int,
        default=d.cell_cluster_distance_threshold,
    )
    p.add_argument("--dapi-overlap-threshold", type=float, default=d.dapi_overlap_threshold)
    p.add_argument("--px-to-um", type=float, default=d.px_to_um)
    p.add_argument("--max-regions", type=int, default=d.max_regions)
    p.add_argument("--no-figures", action="store_true")
    p.add_argument(
        "--profile", action="store_true",
        help="print cumulative per-stage wall times at exit",
    )
    p.add_argument("--strict-reference-errors", action="store_true")


def _cfg_from_args(args) -> AnalysisConfig:
    return AnalysisConfig(
        denoise_size=args.denoise_size,
        dilation_radius=args.dilation_radius,
        distance_threshold=args.distance_threshold,
        cell_cluster_distance_threshold=args.cell_cluster_distance_threshold,
        dapi_overlap_threshold=args.dapi_overlap_threshold,
        px_to_um=args.px_to_um,
        max_regions=args.max_regions,
        strict_reference_errors=args.strict_reference_errors,
    )


def main(argv=None) -> int:
    # usage text must show how the tool was ACTUALLY invoked: the installed
    # console script by its own name, `python -m` runs by the module form
    # (argparse's default would print the unrunnable "cli.py")
    prog = os.path.basename(sys.argv[0] or "")
    if prog in ("", "cli.py", "__main__.py"):
        prog = "python -m particle_col_image_segmentation_tpu"
    parser = argparse.ArgumentParser(
        prog=prog,
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="recursive .h5 label-map analysis")
    p.add_argument("folder", help="top-level folder (strain tokens in path)")
    _add_analysis_flags(p)
    p.add_argument(
        "--space-parallel", type=int, default=0,
        help="devices on the space mesh axis: every plane's ROWS shard "
        "across devices (halo-exchanged CCL/tables/fill/merge), removing "
        "the single-chip plane-size ceiling — plane height must be a "
        "multiple of this",
    )
    p.add_argument(
        "--batch-planes", type=int, default=1,
        help="batch same-shape planes from the whole tree into single "
        "device dispatches of up to this many planes (byte-identical "
        "CSVs; mutually exclusive with --space-parallel)",
    )

    p = sub.add_parser("split", help="split z-stack TIFFs per plane/channel")
    p.add_argument("folder")
    p.add_argument(
        "--channels", type=int, nargs="+", default=[1, 2],
        help="channel indices (default 1 2 = RFP GFP, reference :93)",
    )

    p = sub.add_parser("normalize", help="normalize raw-capture folder tree")
    p.add_argument("folder")

    p = sub.add_parser("refine", help="watershed boundary refinement of a probability .h5")
    p.add_argument("h5_file")
    p.add_argument("--channel", type=int, default=RefineConfig().boundary_channel)
    p.add_argument("--threshold", type=float, default=RefineConfig().boundary_threshold)
    p.add_argument("--out", default=None, help="write refined labels to this .h5")
    p.add_argument("--csv", default=None, help="write per-cell stats to this CSV")
    p.add_argument(
        "--stack", action="store_true",
        help="treat the export as a z-stack ([Z,H,W] / [Z,C,H,W] / "
        "[Z,H,W,C]) and refine all planes in one device graph "
        "(4-D inputs take this path automatically)",
    )
    p.add_argument(
        "--space-parallel", type=int, default=0,
        help="devices on the space mesh axis: plane ROWS shard across "
        "devices (halo-exchanged EDT/CCL/watershed), for probability maps "
        "too large for one chip — plane height must be a multiple of this",
    )
    p.add_argument(
        "--data-parallel", type=int, default=0,
        help="devices on the data mesh axis when refining a stack "
        "(planes split across this many devices; combines with "
        "--space-parallel)",
    )
    p.add_argument(
        "--tunnel-basins", action="store_true",
        help="model priority-flood basin tunneling (basin-component "
        "contraction) in the watershed — for plateaued/quantized "
        "probability maps with sparse markers; with --space-parallel "
        "planes distribute data-parallel (each plane floods on one chip)",
    )

    p = sub.add_parser("nanosims", help="NanoSIMS 5-isotope ROI analysis")
    p.add_argument("mat_folder")
    p.add_argument("rois_png")
    p.add_argument("--bound-png", default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--compat-green-o-bug", action="store_true")
    p.add_argument("--no-figures", action="store_true", dest="ns_no_figures")

    p = sub.add_parser(
        "batch",
        help="stream fused segmentation stats over every .h5 plane "
        "(the scale-out replacement for the reference's folder loop)",
    )
    p.add_argument("folder")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-regions", type=int, default=AnalysisConfig().max_regions)
    p.add_argument(
        "--data-parallel", type=int, default=0,
        help="devices on the data mesh axis (0 = single device)",
    )
    p.add_argument(
        "--space-parallel", type=int, default=0,
        help="devices on the space mesh axis: plane ROWS shard across "
        "devices (halo-exchanged distributed CCL/tables), removing the "
        "single-chip plane-size ceiling — plane height must be a multiple "
        "of this (0/1 = planes stay whole per device)",
    )
    p.add_argument(
        "--particle-val", type=int, default=None,
        help="particle class value (default: derive per file from its "
        "strain/channel tokens, like analyze)",
    )
    p.add_argument(
        "--cell-vals", type=int, nargs="+", default=None,
        help="cell class values (default: derive per file)",
    )
    p.add_argument(
        "--manifest", default=None,
        help="restartable-progress manifest path (skips completed planes)",
    )
    p.add_argument(
        "--pack-transfer", action="store_true",
        help="ship planes 4-bit packed (half the host->device bytes)",
    )
    p.add_argument("--csv", default=None, help="write per-plane stats CSV here")
    p.add_argument(
        "--fail-fast", action="store_true",
        help="abort on the first decode failure instead of logging and "
        "skipping the plane (skipped planes are never marked done, so a "
        "manifest resume retries them)",
    )

    sub.add_parser("bench", help="run the throughput benchmark")

    args = parser.parse_args(argv)

    if args.command == "analyze":
        from particle_col_image_segmentation_tpu.models.experiment import run_analysis

        mesh = None
        if args.space_parallel > 1:
            from particle_col_image_segmentation_tpu.parallel.mesh import (
                make_mesh,
            )

            mesh = make_mesh(n_data=1, n_space=args.space_parallel)
        run_analysis(args.folder, _cfg_from_args(args),
                     make_figures=not args.no_figures, mesh=mesh,
                     batch_planes=args.batch_planes)
        if args.profile:
            from particle_col_image_segmentation_tpu.utils.profiling import (
                STAGE_TOTALS,
            )

            for name, total in sorted(STAGE_TOTALS.items(), key=lambda kv: -kv[1]):
                print(f"profile: {name:24s} {total*1e3:10.1f} ms")
    elif args.command == "split":
        from particle_col_image_segmentation_tpu.models.zsplit import process_folder

        process_folder(args.folder, args.channels)
    elif args.command == "normalize":
        from particle_col_image_segmentation_tpu.io.discovery import normalize_capture_tree

        for folder in normalize_capture_tree(args.folder):
            print("normalized:", folder)
    elif args.command == "refine":
        from particle_col_image_segmentation_tpu.io.hdf5 import (
            load_h5_plane,
            save_h5_plane,
        )
        from particle_col_image_segmentation_tpu.models.refine import (
            refine_boundaries,
            refine_boundaries_stack,
            write_refine_csv,
            write_refine_stack_csv,
        )

        cfg = RefineConfig(
            boundary_threshold=args.threshold, boundary_channel=args.channel,
            tunnel_basins=args.tunnel_basins,
        )
        probs = load_h5_plane(args.h5_file, key="exported_data")
        if args.space_parallel > 1 or args.data_parallel > 1:
            import numpy as np

            from particle_col_image_segmentation_tpu.models.refine import (
                refine_boundaries_sharded,
            )
            from particle_col_image_segmentation_tpu.parallel.mesh import (
                make_mesh,
            )

            mesh = make_mesh(
                n_data=args.data_parallel or 1,
                n_space=max(args.space_parallel, 1),
            )
            as_stack = args.stack or probs.ndim == 4
            results = refine_boundaries_sharded(
                probs, cfg, mesh=mesh, stack=as_stack
            )
            if not as_stack:
                result = results[0]
                print(f"cells: {result.num_cells}")
                if args.out:
                    save_h5_plane(args.out, result.labels)
                    print("labels written to", args.out)
                if args.csv:
                    write_refine_csv(result, args.csv)
                    print("cell stats written to", args.csv)
            else:
                print(f"planes: {len(results)}, cells: "
                      f"{sum(r.num_cells for r in results)}")
                if args.out:
                    save_h5_plane(
                        args.out, np.stack([r.labels for r in results])
                    )
                    print("labels written to", args.out)
                if args.csv:
                    write_refine_stack_csv(results, args.csv)
                    print("cell stats written to", args.csv)
        elif args.stack or probs.ndim == 4:
            import numpy as np

            results = refine_boundaries_stack(probs, cfg)
            print(f"planes: {len(results)}, cells: "
                  f"{sum(r.num_cells for r in results)}")
            if args.out:
                save_h5_plane(
                    args.out, np.stack([r.labels for r in results])
                )
                print("labels written to", args.out)
            if args.csv:
                write_refine_stack_csv(results, args.csv)
                print("cell stats written to", args.csv)
        else:
            result = refine_boundaries(probs, cfg)
            print(f"cells: {result.num_cells}")
            if args.out:
                save_h5_plane(args.out, result.labels)
                print("labels written to", args.out)
            if args.csv:
                write_refine_csv(result, args.csv)
                print("cell stats written to", args.csv)
    elif args.command == "nanosims":
        from particle_col_image_segmentation_tpu.config import NanoSIMSConfig
        from particle_col_image_segmentation_tpu.models.nanosims import run_nanosims

        cfg = NanoSIMSConfig(compat_green_o_bug=args.compat_green_o_bug)
        result = run_nanosims(
            args.mat_folder, args.rois_png, args.bound_png, args.out_dir, cfg,
            make_figures=not args.ns_no_figures,
        )
        print(
            f"red ROIs: {result.red.num_rois}, green ROIs: {result.green.num_rois}; "
            f"CSVs written to {args.out_dir}"
        )
    elif args.command == "batch":
        import csv as _csv

        from particle_col_image_segmentation_tpu.io.discovery import (
            get_h5_files_recursively,
        )
        from particle_col_image_segmentation_tpu.io.hdf5 import load_h5_plane
        from particle_col_image_segmentation_tpu.models.batch import (
            derive_class_values,
            run_batch,
        )
        from particle_col_image_segmentation_tpu.oracle.reference_pipeline import (
            normalize_ds_arr,
        )

        if args.data_parallel and args.batch_size % args.data_parallel != 0:
            parser.error(
                "--batch-size must be a multiple of --data-parallel "
                f"(got {args.batch_size} and {args.data_parallel})"
            )
        if args.space_parallel > 1 and args.pack_transfer:
            parser.error(
                "--pack-transfer is incompatible with --space-parallel "
                "(nibble packing halves W under the row sharding)"
            )

        cfg = AnalysisConfig(max_regions=args.max_regions)
        folder_to_files = get_h5_files_recursively(args.folder)
        paths = [
            os.path.join(folder, f)
            for folder, files in folder_to_files.items()
            for f in files
        ]
        if not paths:
            print("no .h5 planes found under", args.folder)
            return 1
        # class values per file: explicit flags win (either flag alone
        # overrides its half); otherwise derive from the path tokens
        # (analyze's rules) and group same-signature paths so each group
        # runs one statically-shaped fused fn
        if args.particle_val is not None and args.cell_vals is not None:
            groups = {(args.particle_val, tuple(args.cell_vals)): paths}
        else:
            sig_of = derive_class_values(folder_to_files)
            groups = {}
            for path in paths:
                pv, cv = sig_of[path]
                if args.particle_val is not None:
                    pv = args.particle_val
                if args.cell_vals is not None:
                    cv = tuple(args.cell_vals)
                groups.setdefault((pv, cv), []).append(path)
        mesh = None
        if args.data_parallel or args.space_parallel > 1:
            from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(
                n_data=args.data_parallel or 1,
                n_space=max(args.space_parallel, 1),
            )
        manifest = None
        if args.manifest:
            from particle_col_image_segmentation_tpu.utils.manifest import (
                RunManifest,
            )

            manifest = RunManifest(args.manifest)

        def load_fn(path: str):
            return normalize_ds_arr(load_h5_plane(path), cfg)

        sink = None
        writer = None
        if args.csv:
            # append on an ACTUAL manifest resume (completed planes exist
            # whose rows live only in the old CSV): truncating would lose
            # them.  A fresh manifest + leftover CSV must truncate, or every
            # re-processed plane appends a duplicate row.
            resume = (
                manifest is not None and manifest.done_count > 0
                and os.path.exists(args.csv)
            )
            sink = open(args.csv, "a" if resume else "w", newline="")
            writer = _csv.writer(sink)
            if not resume:
                writer.writerow(
                    ["plane", "regions", "particle_px", "cell_px", "status"]
                )
        try:
            for (particle_val, cell_vals), group_paths in groups.items():
                for path, stats in run_batch(
                    group_paths, load_fn, cfg, batch_size=args.batch_size,
                    particle_val=particle_val, cell_vals=cell_vals,
                    mesh=mesh, manifest=manifest,
                    pack_transfer=args.pack_transfer,
                    on_error="raise" if args.fail_fast else "skip",
                ):
                    flag = " OVERFLOW(raise --max-regions)" if stats.overflow else ""
                    if not stats.converged:
                        flag += " UNCONVERGED(stats invalid)"
                    print(
                        f"{path}: regions={stats.num_regions} "
                        f"particle_px={stats.particle_px} cell_px={stats.cell_px}"
                        f"{flag}"
                    )
                    if writer is not None:
                        # a status column keeps rows self-describing: an
                        # unconverged plane is not marked done in the
                        # manifest, so a resume appends a second (valid) row
                        # for the same plane — consumers keep rows with
                        # status == "ok"
                        # unconverged wins over overflow: unconverged stats
                        # are invalid wholesale (a garbage num_regions can
                        # also trip the overflow flag), while overflow rows
                        # are valid undercounts
                        status = (
                            "unconverged" if not stats.converged
                            else ("overflow" if stats.overflow else "ok")
                        )
                        writer.writerow(
                            [path, stats.num_regions, stats.particle_px,
                             stats.cell_px, status]
                        )
                        # flush BEFORE control returns to run_batch, which
                        # fsyncs the manifest next: a crash after mark_done
                        # with this row still buffered would lose it forever
                        # (resume skips the plane)
                        sink.flush()
        finally:
            if sink is not None:
                sink.close()
    elif args.command == "bench":
        import subprocess

        bench = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench.py",
        )
        if not os.path.exists(bench):
            # bench.py ships with the source checkout, not the wheel
            parser.error(
                f"bench.py not found at {bench} — the benchmark runs from a "
                "source checkout (git clone), not an installed package"
            )
        return subprocess.call([sys.executable, bench])
    return 0


if __name__ == "__main__":
    sys.exit(main())
