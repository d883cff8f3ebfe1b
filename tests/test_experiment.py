"""Integration tests: folder-level flows produce reference-exact CSVs.

The expected CSVs are generated independently by replicating the reference's
orchestration with the CPU oracle functions; the framework's output must
match byte-for-byte.
"""

import os

import numpy as np
import pytest

from particle_col_image_segmentation_tpu.config import (
    BASE_TYPE_MAP,
    AnalysisConfig,
)
from particle_col_image_segmentation_tpu.io.discovery import (
    get_h5_files_recursively,
)
from particle_col_image_segmentation_tpu.io.hdf5 import save_h5_plane
from particle_col_image_segmentation_tpu.models import experiment
from particle_col_image_segmentation_tpu.oracle import reference_pipeline as rp
from particle_col_image_segmentation_tpu.report.csvio import (
    write_cell_position_info,
    write_density_info,
    write_merged_cell_position_info,
)

from fixtures import synthetic_label_plane
from parity import write_expected_multichannel_csvs, write_expected_single_csvs

CFG = AnalysisConfig(max_regions=4096)


def _read(path):
    with open(path) as f:
        return f.read()


class TestSingleFileFlow:
    def test_csvs_match_oracle(self, tmp_path):
        folder = tmp_path / "exp" / "24h" / "Tp_3D05_1_24h_60X_15"
        folder.mkdir(parents=True)
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = synthetic_label_plane(seed=21, cell_types=cell_types, shape=(192, 192))
        h5 = folder / "Tp_3D05_1_24h_60X_15_labels.h5"
        save_h5_plane(str(h5), img[None])  # (1,H,W) exercises normalize

        experiment.process_single_h5_file(
            str(folder), h5.name, CFG, make_figures=False
        )

        pos_csv = folder / "Tp_3D05_1_24h_60X_15_cell_pos.csv"
        merged_csv = folder / "Tp_3D05_1_24h_60X_15_merged_cell_pos.csv"
        density_csv = folder.parent / "exp_24h_cell_density_info.csv"
        assert pos_csv.exists() and merged_csv.exists() and density_csv.exists()

        # oracle replication of the reference flow (:627-671)
        exp_dir = tmp_path / "expected"
        exp_dir.mkdir()
        want = write_expected_single_csvs(
            img, cell_types, CFG, str(exp_dir), "Tp_3D05_1_24h_60X_15"
        )
        assert _read(pos_csv) == _read(want["pos"])
        assert _read(merged_csv) == _read(want["merged"])
        assert _read(density_csv) == _read(want["density"])

    def test_density_rerun_replaces_rows(self, tmp_path):
        folder = tmp_path / "exp" / "24h" / "Tp_3D05_1_24h_60X_15"
        folder.mkdir(parents=True)
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = synthetic_label_plane(seed=22, cell_types=cell_types, shape=(160, 160))
        h5 = folder / "Tp_3D05_1_24h_60X_15_labels.h5"
        save_h5_plane(str(h5), img)
        experiment.process_single_h5_file(str(folder), h5.name, CFG, make_figures=False)
        experiment.process_single_h5_file(str(folder), h5.name, CFG, make_figures=False)
        density_csv = folder.parent / "exp_24h_cell_density_info.csv"
        lines = _read(density_csv).strip().splitlines()
        # header + one strain row, no duplicates after re-run (reference :1078-1107)
        assert len(lines) == 2


class TestBatchedAnalyze:
    def test_batched_tree_csvs_byte_identical(self, tmp_path):
        """``run_analysis(batch_planes=N)`` (CLI ``analyze --batch-planes``)
        must produce byte-identical CSVs to the sequential per-plane run on
        a multi-folder tree mixing single-file folders (batched with
        compute_merge) and a multi-channel folder (per-channel planes
        batched, dedup/fusion inline)."""

        def build_tree(root):
            # 3 single-file 3D05 folders (same cell-type map + shape →
            # one batch group)
            for i in range(3):
                folder = root / "exp" / "24h" / f"Tp_3D05_{i}_24h_60X"
                folder.mkdir(parents=True)
                cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
                img = synthetic_label_plane(
                    seed=60 + i, cell_types=cell_types, shape=(160, 160)
                )
                save_h5_plane(
                    str(folder / f"Tp_3D05_{i}_24h_60X_labels.h5"), img
                )
            # one multi-channel 6B07+C3M10 folder (RFP particle-only +
            # GFP + DAPI; module docstring rules)
            mf = root / "exp" / "24h" / "Tp_6B07_C3M10_1_24h_60X"
            mf.mkdir(parents=True)
            rfp_types = {1: "Particle", 2: "Background"}
            ch_types = {1: "C3M10", 2: "Particle", 3: "Background"}
            dapi_types = {1: "6B07", 2: "Particle", 3: "Background"}
            save_h5_plane(
                str(mf / "Tp_6B07_C3M10_1_24h_60X_RFP.h5"),
                synthetic_label_plane(seed=70, cell_types=rfp_types,
                                      shape=(160, 160)),
            )
            save_h5_plane(
                str(mf / "Tp_6B07_C3M10_1_24h_60X_GFP.h5"),
                synthetic_label_plane(seed=71, cell_types=ch_types,
                                      shape=(160, 160)),
            )
            save_h5_plane(
                str(mf / "Tp_6B07_C3M10_1_24h_60X_DAPI.h5"),
                synthetic_label_plane(seed=72, cell_types=dapi_types,
                                      shape=(160, 160)),
            )
            return root / "exp"

        seq_root = build_tree(tmp_path / "seq")
        bat_root = build_tree(tmp_path / "bat")
        experiment.run_analysis(str(seq_root), CFG, make_figures=False)
        experiment.run_analysis(str(bat_root), CFG, make_figures=False,
                                batch_planes=8)

        seq_csvs = sorted(
            os.path.relpath(os.path.join(d, f), seq_root)
            for d, _, fs in os.walk(seq_root) for f in fs
            if f.endswith(".csv")
        )
        bat_csvs = sorted(
            os.path.relpath(os.path.join(d, f), bat_root)
            for d, _, fs in os.walk(bat_root) for f in fs
            if f.endswith(".csv")
        )
        assert seq_csvs == bat_csvs and len(seq_csvs) >= 7
        for rel in seq_csvs:
            assert _read(os.path.join(seq_root, rel)) == _read(
                os.path.join(bat_root, rel)
            ), rel

    def test_batched_streaming_peak_live(self, tmp_path):
        """The provider must stream: at most one chunk of device outs alive
        at a time (VERDICT r4: the eager precompute held the WHOLE tree's
        PlaneDeviceOuts — ~25 MB HBM per 2048² plane — until each folder
        consumed its slice), and every consumed entry dropped for good."""
        root = tmp_path / "exp" / "24h"
        cell_types = {1: "3D05", 2: "Particle", 3: "Background"}
        for i in range(5):
            folder = root / f"Tp_3D05_{i}_24h_60X"
            folder.mkdir(parents=True)
            save_h5_plane(
                str(folder / f"Tp_3D05_{i}_24h_60X_labels.h5"),
                synthetic_label_plane(seed=80 + i, cell_types=cell_types,
                                      shape=(160, 160)),
            )
        folders = get_h5_files_recursively(str(tmp_path / "exp"))
        outs = experiment._batch_device_outs(folders, CFG, 2)
        assert outs.peak_live == 0  # lazy: nothing computed up front
        got = 0
        for folder, files in folders.items():
            fp = os.path.join(folder, files[0])
            pre = outs.get(fp)
            if pre is not None:
                got += 1
                assert outs.get(fp) is None  # consume-once
            # one chunk of 2 at a time, minus already-consumed entries
            assert outs.live <= 2
        # 5 planes, batch_planes=2 → two chunks of 2 + one singleton the
        # folder flow dispatches itself
        assert got == 4
        assert outs.peak_live == 2
        assert outs.live == 0

    def test_batch_planes_rejects_mesh(self, tmp_path):
        with pytest.raises(ValueError, match="batch_planes"):
            experiment.run_analysis(
                str(tmp_path), CFG, make_figures=False, mesh=object(),
                batch_planes=4,
            )


class TestMultiChannelFlow:
    def test_three_channel_6b07_c3m10(self, tmp_path):
        """The 6B07+C3M10 condition: RFP carries no cell class (module
        docstring rule), DAPI dedups against GFP, fusion remaps RFP 1→4, 2→5."""
        folder = tmp_path / "6B07_C3M10" / "48h" / "Tp_2_48h_60X_3"
        folder.mkdir(parents=True)
        rfp_types = {1: "Particle", 2: "Background"}
        dapi_types = {1: "6B07", 2: "Particle", 3: "Background"}
        gfp_types = {1: "C3M10", 2: "Particle", 3: "Background"}
        rfp = synthetic_label_plane(
            seed=41, cell_types=rfp_types, shape=(160, 160),
            n_cells_per_strain=0, n_clusters_per_strain=0,
        )
        dapi = synthetic_label_plane(seed=42, cell_types=dapi_types, shape=(160, 160))
        gfp = synthetic_label_plane(seed=43, cell_types=gfp_types, shape=(160, 160))
        files = [
            "Tp_2_48h_60X_3_RFP_labels.h5",
            "Tp_2_48h_60X_3_DAPI_labels.h5",
            "Tp_2_48h_60X_3_GFP_labels.h5",
        ]
        for f, arr in zip(files, (rfp, dapi, gfp)):
            save_h5_plane(str(folder / f), arr)

        experiment.process_multiple_h5_files(str(folder), files, CFG, make_figures=False)

        density_csv = folder.parent / "6B07_C3M10_48h_cell_density_info.csv"
        combined_csv = folder / "Tp_2_48h_60X_3_cell_pos_combined.csv"
        assert density_csv.exists() and combined_csv.exists()

        # oracle replication (RFP carries no cell class under 6B07+C3M10)
        exp_dir = tmp_path / "expected3"
        exp_dir.mkdir()
        want = write_expected_multichannel_csvs(
            {"RFP": rfp, "DAPI": dapi, "GFP": gfp}, ["6B07", "C3M10"], CFG,
            str(exp_dir), "Tp_2_48h_60X_3",
        )
        raw_csv = folder / "Tp_2_48h_60X_3_cell_pos_raw.csv"
        merged_csv = folder / "Tp_2_48h_60X_3_merged_cell_pos.csv"
        for got, key in ((raw_csv, "raw"), (density_csv, "density"),
                         (combined_csv, "combined"), (merged_csv, "merged")):
            assert _read(got) == _read(want[key]), key

    @pytest.mark.skipif(
        len(__import__("jax").devices()) < 8, reason="needs 8 devices"
    )
    @pytest.mark.slow  # ~43 s CPU compile; fast-lane sharded parity:
    # test_sharded_merge/refine/tables_match_* (test_parallel.py)
    def test_three_channel_space_sharded_matches_single_device(self, tmp_path):
        """The FULL multi-channel flow (per-channel analysis, sharded DAPI
        dedup, fusion re-analysis, merge) on a 1×8 space mesh must write
        byte-identical CSVs to the single-device run — `analyze
        --space-parallel` end-to-end (VERDICT r2 #2, main analysis path)."""
        from particle_col_image_segmentation_tpu.cli import main
        from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh

        rfp_types = {1: "Particle", 2: "Background"}
        dapi_types = {1: "6B07", 2: "Particle", 3: "Background"}
        gfp_types = {1: "C3M10", 2: "Particle", 3: "Background"}
        rfp = synthetic_label_plane(
            seed=41, cell_types=rfp_types, shape=(160, 160),
            n_cells_per_strain=0, n_clusters_per_strain=0,
        )
        dapi = synthetic_label_plane(seed=42, cell_types=dapi_types, shape=(160, 160))
        gfp = synthetic_label_plane(seed=43, cell_types=gfp_types, shape=(160, 160))
        files = [
            "Tp_2_48h_60X_3_RFP_labels.h5",
            "Tp_2_48h_60X_3_DAPI_labels.h5",
            "Tp_2_48h_60X_3_GFP_labels.h5",
        ]

        def run(sub, mesh=None, cli=False):
            folder = tmp_path / sub / "6B07_C3M10" / "48h" / "Tp_2_48h_60X_3"
            folder.mkdir(parents=True)
            for f, arr in zip(files, (rfp, dapi, gfp)):
                save_h5_plane(str(folder / f), arr)
            if cli:
                rc = main(["analyze", str(tmp_path / sub), "--no-figures",
                           "--max-regions", "4096",
                           "--space-parallel", "8"])
                assert rc == 0
            else:
                experiment.process_multiple_h5_files(
                    str(folder), files, CFG, make_figures=False, mesh=mesh
                )
            return {
                "density": _read(folder.parent / "6B07_C3M10_48h_cell_density_info.csv"),
                "combined": _read(folder / "Tp_2_48h_60X_3_cell_pos_combined.csv"),
                "raw": _read(folder / "Tp_2_48h_60X_3_cell_pos_raw.csv"),
                "merged": _read(folder / "Tp_2_48h_60X_3_merged_cell_pos.csv"),
            }

        ref = run("single")
        got = run("sharded", mesh=make_mesh(n_data=1, n_space=8))
        assert got == ref
        via_cli = run("cli", cli=True)
        assert via_cli == ref

    def test_missing_channel_raises_clearly(self, tmp_path):
        """A multi-strain folder lacking the DAPI capture must raise a
        ValueError naming the missing channel, not a bare KeyError."""
        folder = tmp_path / "6B07_C3M10" / "48h" / "Tp_9_48h_60X_1"
        folder.mkdir(parents=True)
        rfp_types = {1: "Particle", 2: "Background"}
        rfp = synthetic_label_plane(
            seed=44, cell_types=rfp_types, shape=(96, 96),
            n_cells_per_strain=0, n_clusters_per_strain=0,
        )
        files = ["Tp_9_48h_60X_1_RFP_labels.h5"]
        save_h5_plane(str(folder / files[0]), rfp)
        with pytest.raises(ValueError, match="DAPI"):
            experiment.process_multiple_h5_files(
                str(folder), files, CFG, make_figures=False
            )

    def test_trailing_slash_folder_name(self, tmp_path):
        """A trailing-slash folder path must not produce empty density-CSV
        keys / figure titles (split('/')[-1] regression)."""
        folder = tmp_path / "3D05" / "24h" / "Tp_7_24h_60X_2"
        folder.mkdir(parents=True)
        types = {1: "3D05", 2: "Particle", 3: "Background"}
        img = synthetic_label_plane(seed=45, cell_types=types, shape=(96, 96))
        name = "Tp_7_3D05_24h_60X_2_labels.h5"
        save_h5_plane(str(folder / name), img)
        experiment.process_single_h5_file(
            str(folder) + "/", name, CFG, make_figures=False
        )
        density_csv = folder.parent / "3D05_24h_cell_density_info.csv"
        rows = _read(density_csv).strip().splitlines()
        assert all(
            r.startswith("Tp_7_24h_60X_2,") for r in rows[1:]
        ), rows

    def test_two_channel_3d05_6b07(self, tmp_path):
        folder = tmp_path / "3D05_6B07" / "24h" / "Tp_1_24h_60X_7"
        folder.mkdir(parents=True)
        # RFP: {1: 3D05, 2: Particle, 3: Background}
        rfp_types = {1: "3D05", 2: "Particle", 3: "Background"}
        dapi_types = {1: "6B07", 2: "Particle", 3: "Background"}
        rfp = synthetic_label_plane(seed=31, cell_types=rfp_types, shape=(192, 192))
        dapi = synthetic_label_plane(seed=32, cell_types=dapi_types, shape=(192, 192))
        save_h5_plane(str(folder / "Tp_1_24h_60X_7_RFP_labels.h5"), rfp)
        save_h5_plane(str(folder / "Tp_1_24h_60X_7_DAPI_labels.h5"), dapi)

        experiment.process_multiple_h5_files(
            str(folder),
            ["Tp_1_24h_60X_7_RFP_labels.h5", "Tp_1_24h_60X_7_DAPI_labels.h5"],
            CFG,
            make_figures=False,
        )

        raw_csv = folder / "Tp_1_24h_60X_7_cell_pos_raw.csv"
        combined_csv = folder / "Tp_1_24h_60X_7_cell_pos_combined.csv"
        merged_csv = folder / "Tp_1_24h_60X_7_merged_cell_pos.csv"
        density_csv = folder.parent / "3D05_6B07_24h_cell_density_info.csv"
        for p in (raw_csv, combined_csv, merged_csv, density_csv):
            assert p.exists(), p

        # --- oracle replication of reference :92-222 ---
        den_rfp = rp.denoise(rfp, CFG)
        den_dapi = rp.denoise(dapi, CFG)
        pos_r, cl_r, pa_r, _ = rp.get_cell_positions_and_areas(den_rfp, rfp_types, cfg=CFG)
        _, rfp_area = rp.recreate_particle_area(den_rfp.copy(), rfp_types, pa_r, CFG)
        pos_d, cl_d, _, _ = rp.get_cell_positions_and_areas(den_dapi, dapi_types, cfg=CFG)
        master_pos = {**pos_r, **pos_d}
        master_cl = {**cl_r, **cl_d}
        exp_dir = tmp_path / "expected"
        exp_dir.mkdir()
        write_cell_position_info(master_pos, master_cl, str(exp_dir / "raw.csv"), rfp_area, CFG)
        assert _read(raw_csv) == _read(exp_dir / "raw.csv")

        dapi_updated = rp.combine_cell_positions_and_clusters(den_dapi, den_rfp, CFG)
        pos_d2, cl_d2, _, _ = rp.get_cell_positions_and_areas(dapi_updated, dapi_types, cfg=CFG)
        master_pos["6B07"] = pos_d2["6B07"]
        master_cl["6B07"] = cl_d2["6B07"]
        counts, dens, ratios = rp.get_cell_counts_and_densities(
            master_pos, master_cl, rfp_area, CFG
        )
        write_density_info(str(exp_dir / "density.csv"), "Tp_1_24h_60X_7", dens, ratios, counts)
        assert _read(density_csv) == _read(exp_dir / "density.csv")

        fused = rp.get_rfp_base_arr(den_rfp.copy(), ["3D05", "6B07"])
        fused = rp.combine_channels(fused, {"RFP": den_rfp, "DAPI": den_dapi}, ["3D05", "6B07"])
        _, _, _, merged = rp.get_cell_positions_and_areas(
            fused, BASE_TYPE_MAP, merged=True, cfg=CFG
        )
        write_cell_position_info(master_pos, master_cl, str(exp_dir / "combined.csv"), rfp_area, CFG)
        write_merged_cell_position_info(merged, str(exp_dir / "merged.csv"), rfp_area, CFG)
        assert _read(combined_csv) == _read(exp_dir / "combined.csv")
        assert _read(merged_csv) == _read(exp_dir / "merged.csv")
