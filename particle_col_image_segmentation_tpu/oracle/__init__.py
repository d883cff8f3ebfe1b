"""CPU oracle: reference-semantics NumPy/SciPy implementations.

skimage and tifffile are not available in this environment, so the oracle
reimplements the handful of skimage primitives the reference relies on
(label, regionprops, disk, binary_dilation, local_maxima, watershed) in pure
NumPy/SciPy, following the documented skimage semantics.  Every device kernel and
pipeline is parity-tested against this oracle.
"""

from particle_col_image_segmentation_tpu.oracle import ndimage  # noqa: F401
from particle_col_image_segmentation_tpu.oracle import reference_pipeline  # noqa: F401
