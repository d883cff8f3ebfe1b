from particle_col_image_segmentation_tpu.ops.filters import (  # noqa: F401
    gaussian_blur,
    median_label_filter,
)
from particle_col_image_segmentation_tpu.ops.ccl import (  # noqa: F401
    compact_labels,
    connected_components,
    label_image,
)
from particle_col_image_segmentation_tpu.ops.regionprops import (  # noqa: F401
    CentroidTable,
    RegionTable,
    centroid_sums,
    centroids_f64,
    centroids_int,
    region_counts,
    region_props,
    table_lookup,
)
from particle_col_image_segmentation_tpu.ops.edt import (  # noqa: F401
    edt,
    edt_exact,
    edt_sq,
    edt_sq_exact,
    edt_sq_exact_auto,
)
from particle_col_image_segmentation_tpu.ops.morphology import (  # noqa: F401
    boundary_mask,
    close_disk,
    dilate_disk,
    erode_disk,
    fill_holes,
    local_maxima,
    open_disk,
)
from particle_col_image_segmentation_tpu.ops.threshold import (  # noqa: F401
    otsu_threshold,
    threshold_and_count,
)
from particle_col_image_segmentation_tpu.ops.watershed import (  # noqa: F401
    watershed,
)
