"""Shared device-vs-oracle parity checks.

One canonical check body per flow, used by the unit tests
(test_single_channel.py, test_experiment.py), the soak sweep
(scripts/soak_fuzz.py) and chip_smoke.py, so they can never drift apart in
what they compare: the plane-level assertion, and oracle replications of
the reference's single-file and multi-channel folder flows that write the
expected CSVs.
"""

from __future__ import annotations

import os

import numpy as np

from particle_col_image_segmentation_tpu.config import BASE_TYPE_MAP
from particle_col_image_segmentation_tpu.labels import classmaps
from particle_col_image_segmentation_tpu.models import analyze_plane
from particle_col_image_segmentation_tpu.oracle import reference_pipeline as rp
from particle_col_image_segmentation_tpu.report.csvio import (
    write_cell_position_info,
    write_density_info,
    write_merged_cell_position_info,
)


def assert_regions_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.area == b.area
        np.testing.assert_allclose(a.centroid, b.centroid, rtol=0, atol=1e-9)
        assert a.bbox == b.bbox


def assert_plane_parity(img, cell_types, cfg):
    """Run analyze_plane(merged=True) and assert full parity with the
    oracle: denoise, positions/clusters (area+centroid+bbox per region),
    cluster.cells, merged groups (incl. member regions), particle fill,
    and counts/densities."""
    ours = analyze_plane(img, cell_types, cfg, merged=True)
    assert_analysis_parity(ours, img, cell_types, cfg, merged=True)
    return ours


def assert_analysis_parity(ours, img, cell_types, cfg, merged=True):
    """Assert a PlaneAnalysis of the raw plane ``img`` matches the oracle;
    ``merged`` says whether the analysis computed merge groups."""
    den = rp.denoise(img, cfg)
    np.testing.assert_array_equal(ours.denoised, den)
    pos, clusters, particle_area, merged_ref = rp.get_cell_positions_and_areas(
        den, cell_types, merged=merged, cfg=cfg
    )
    assert ours.particle_area == particle_area
    assert list(ours.cell_pos) == list(pos)
    for k in pos:
        assert_regions_equal(ours.cell_pos[k], pos[k])
        assert_regions_equal(ours.cell_clusters[k], clusters[k])
        assert [c.cells for c in ours.cell_clusters[k]] == [
            c.cells for c in clusters[k]
        ]

    if merged:
        # merged groups, including per-member region stats
        assert list(ours.merged_clusters) == list(merged_ref)
        for k in merged_ref:
            assert len(ours.merged_clusters[k]) == len(merged_ref[k])
            for ga, gb in zip(ours.merged_clusters[k], merged_ref[k]):
                assert ga["area"] == gb["area"]
                np.testing.assert_allclose(
                    ga["centroid"], gb["centroid"], atol=1e-9
                )
                assert ga["bbox"] == gb["bbox"]
                assert_regions_equal(ga["regions"], gb["regions"])

    # particle fill
    filled_ref, filled_area_ref = rp.recreate_particle_area(
        den.copy(), cell_types, particle_area, cfg
    )
    np.testing.assert_array_equal(ours.filled, filled_ref)
    assert ours.filled_particle_area == filled_area_ref

    # counts/densities through the shared reducer
    ours_cnt = rp.get_cell_counts_and_densities(
        ours.cell_pos, ours.cell_clusters, particle_area, cfg
    )
    ref_cnt = rp.get_cell_counts_and_densities(pos, clusters, particle_area, cfg)
    assert ours_cnt == ref_cnt


def write_expected_single_csvs(img, cell_types, cfg, out_dir, folder_name):
    """Oracle replication of the single-file flow (reference :627-671):
    writes the expected position, merged and density CSVs into ``out_dir``
    and returns their paths keyed "pos", "merged", "density"."""
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
    out = {k: os.path.join(out_dir, f"{k}.csv")
           for k in ("pos", "merged", "density")}
    write_cell_position_info(pos, clusters, out["pos"], filled_area, cfg)
    write_merged_cell_position_info(merged, out["merged"], filled_area, cfg)
    write_density_info(out["density"], folder_name, dens, ratios, counts)
    return out


def write_expected_multichannel_csvs(planes, strains, cfg, out_dir,
                                     folder_name):
    """Oracle replication of the multi-channel flow (reference :92-222) for
    ``planes`` = {channel: raw label plane} in file order: per-channel
    analysis, RFP particle area, DAPI dedup against the other channel,
    fusion and the fused merge.  Writes the expected raw, density, combined
    and merged CSVs into ``out_dir`` and returns their paths by those
    keys."""
    dens = {}
    master_pos, master_cl = {}, {}
    rfp_area = None
    for ch, img in planes.items():
        types = classmaps.get_cell_type_map_from_channel(strains, ch)
        den = rp.denoise(img, cfg)
        dens[ch] = den
        pos, cl, pa, _ = rp.get_cell_positions_and_areas(den, types, cfg=cfg)
        if ch == "RFP":
            _, rfp_area = rp.recreate_particle_area(den.copy(), types, pa, cfg)
            if types[1] == "Particle":  # no cell class on this plane
                continue
        master_pos.update(pos)
        master_cl.update(cl)
    out = {k: os.path.join(out_dir, f"{k}.csv")
           for k in ("raw", "density", "combined", "merged")}
    write_cell_position_info(master_pos, master_cl, out["raw"], rfp_area, cfg)
    if len(strains) > 1:
        other = "GFP" if strains == ["6B07", "C3M10"] else "RFP"
        dapi_types = classmaps.get_cell_type_map_from_channel(strains, "DAPI")
        dapi_updated = rp.combine_cell_positions_and_clusters(
            dens["DAPI"], dens[other], cfg
        )
        pos_d, cl_d, _, _ = rp.get_cell_positions_and_areas(
            dapi_updated, dapi_types, cfg=cfg
        )
        master_pos["6B07"] = pos_d.get("6B07", [])
        master_cl["6B07"] = cl_d.get("6B07", [])
    counts, densities, ratios = rp.get_cell_counts_and_densities(
        master_pos, master_cl, rfp_area, cfg
    )
    write_density_info(out["density"], folder_name, densities, ratios, counts)
    fused = rp.get_rfp_base_arr(dens["RFP"].copy(), strains)
    fused = rp.combine_channels(fused, dens, strains)
    _, _, _, merged = rp.get_cell_positions_and_areas(
        fused, BASE_TYPE_MAP, merged=True, cfg=cfg
    )
    write_cell_position_info(master_pos, master_cl, out["combined"], rfp_area,
                             cfg)
    write_merged_cell_position_info(merged, out["merged"], rfp_area, cfg)
    return out
