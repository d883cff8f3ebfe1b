"""Worker for the multi-process jax.distributed test (test_multihost.py).

Run as: python _multihost_worker.py <coordinator> <process_id>
with env JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=2.

Each of the 2 processes contributes 2 virtual CPU devices; the global mesh
is 2 (data, across processes) × 2 (space, within a process), so the sharded
segmentation's halo exchanges and psums genuinely cross the process
boundary.  Process-local results are checked against the single-device
fused pass in the same process; both processes print MULTIHOST-PASS-<pid>.
"""

import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from particle_col_image_segmentation_tpu.parallel.mesh import (  # noqa: E402
    DATA_AXIS,
    SPACE_AXIS,
    initialize_multihost,
)

mesh = initialize_multihost(
    coordinator_address=coord, num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()
assert dict(mesh.shape) == {DATA_AXIS: 2, SPACE_AXIS: 2}, mesh.shape
# each mesh row must be one process (halos ride intra-host links)
row_procs = {d.process_index for d in mesh.devices[pid]}
assert row_procs == {pid}, (pid, mesh.devices)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from fixtures import synthetic_label_plane  # noqa: E402
from particle_col_image_segmentation_tpu.config import AnalysisConfig  # noqa: E402
from particle_col_image_segmentation_tpu.models.batch import (  # noqa: E402
    fused_segment_batch,
)
from particle_col_image_segmentation_tpu.parallel.sharded import (  # noqa: E402
    make_sharded_segment_fn,
)

cfg = AnalysisConfig(max_regions=1023)
batch = np.stack(
    [synthetic_label_plane(seed=s, shape=(64, 64)) for s in (300, 301)]
)
sharding = NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS, None))
garr = jax.make_array_from_callback(batch.shape, sharding, lambda i: batch[i])

fn = make_sharded_segment_fn(mesh, cfg, particle_val=2, cell_vals=(1,))
den, lab, particle_ct, n_comp, filled, overlap_ct, conv = fn(garr)

pct = np.asarray(multihost_utils.process_allgather(particle_ct, tiled=True))
ncomp = np.asarray(multihost_utils.process_allgather(n_comp, tiled=True))
convg = np.asarray(multihost_utils.process_allgather(conv, tiled=True))
assert convg.all(), convg

# single-device reference in the same process (plain local jit)
_, ref_num, _, _, ref_part, _, _, ref_conv = fused_segment_batch(
    jnp.asarray(batch), cfg
)
np.testing.assert_array_equal(ncomp, np.asarray(ref_num))
np.testing.assert_array_equal(pct, np.asarray(ref_part))
assert bool(np.asarray(ref_conv).all())

print(f"MULTIHOST-PASS-{pid}", flush=True)
