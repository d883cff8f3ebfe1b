"""particle_col_image_segmentation_tpu — a JAX microscopy segmentation framework.

A ground-up JAX/XLA rebuild of the capabilities of
``ssilverman16/particle_col_image_segmentation`` (reference mounted read-only at
/root/reference): fluorescence-microscopy particle-colonization analysis.

Layer map (see SURVEY.md §1):
  io/        host-side TIFF/HDF5 codecs, folder discovery, batch loaders
  ops/       device kernels: label-median filter, CCL, EDT, morphology,
             watershed, segment-reduce regionprops, pairwise distances
  labels/    class maps + region analytics (area partition, cluster merge,
             particle fill, DAPI dedup, counts/densities)
  models/    jit-compiled end-to-end pipelines (single-channel, multi-channel
             fusion, watershed refine, NanoSIMS)
  parallel/  mesh definitions, batch + spatial sharding, halo exchange
  report/    CSV writers with the reference's exact schemas
  viz/       matplotlib parity figures
  oracle/    pure NumPy/SciPy implementation of the reference semantics —
             the ground truth for every parity test
"""

__version__ = "0.1.0"

from particle_col_image_segmentation_tpu.config import AnalysisConfig  # noqa: F401
