"""Streaming end-to-end budget decomposition (VERDICT r2 #8).

Separates the three budgets of BASELINE config #5's streaming path so
"device throughput is the binding constraint on real hosts" gets numbers
instead of an extrapolation:

  decode    host work per batch: HDF5 read + normalize (the run_batch
            load_fn), measured with no device in the loop
  transfer  host->device: jax.device_put of a decoded batch + sync
  compute   fused segmentation on PRE-STAGED device-resident batches
            (no host bytes move inside the timed region)

Prints one JSON line with MP/s per stage and the serial/overlapped
end-to-end predictions.  Run on the chip:
  python scripts/stream_decompose.py            # real platform
  JAX_PLATFORMS=cpu python scripts/stream_decompose.py --cpu  # mechanics
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H = W = 2048
BATCH = int(os.environ.get("PCIS_BENCH_BATCH", "8"))
REPS = 3


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        global H, W, BATCH
        H = W = 256
    import h5py
    import jax
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.config import AnalysisConfig
    from particle_col_image_segmentation_tpu.io.hdf5 import load_h5_plane
    from particle_col_image_segmentation_tpu.models.batch import (
        fused_segment_batch,
    )
    from particle_col_image_segmentation_tpu.oracle.reference_pipeline import (
        normalize_ds_arr,
    )

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    from fixtures import synthetic_label_plane

    cfg = AnalysisConfig(max_regions=16383)
    mp_batch = BATCH * H * W / 1e6

    with tempfile.TemporaryDirectory() as td:
        paths = []
        for b in range(BATCH):
            img = synthetic_label_plane(
                seed=500 + b, shape=(H, W),
                n_cells_per_strain=max(8, 640 * H // 2048),
            )
            p = os.path.join(td, f"p{b}.h5")
            with h5py.File(p, "w") as f:
                f.create_dataset("exported_data", data=img[None])
            paths.append(p)

        # --- decode budget (pure host, no device) ----------------------
        def decode_all():
            return np.stack(
                [normalize_ds_arr(load_h5_plane(p), cfg) for p in paths]
            )

        batch_np = decode_all()  # warm page cache
        t0 = time.perf_counter()
        for _ in range(REPS):
            batch_np = decode_all()
        decode_s = (time.perf_counter() - t0) / REPS

        # --- transfer budget (host->device + sync) ----------------------
        dev = jax.device_put(batch_np)
        _ = int(jnp.sum(dev[0, 0, :8]))  # materialize
        t0 = time.perf_counter()
        for _ in range(REPS):
            dev = jax.device_put(batch_np)
            _ = int(jnp.sum(dev[0, 0, :8]))  # scalar readback = real sync
        transfer_s = (time.perf_counter() - t0) / REPS

        # --- compute budget (pre-staged device-resident batch) ----------
        @jax.jit
        def segment_pass(x):
            seg, num, areas, classes, particle_px, cell_px, class_px, conv = (
                fused_segment_batch(x, cfg)
            )
            return jnp.sum(num) + jnp.sum(areas) + jnp.sum(particle_px)

        _ = int(jnp.stack([segment_pass(dev) for _ in range(3)]).sum())
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            fps = [segment_pass(dev) for _ in range(REPS)]
            _ = int(jnp.stack(fps).sum())
            best = min(best, (time.perf_counter() - t0) / REPS)
        compute_s = best

    serial = decode_s + transfer_s + compute_s
    overlapped = max(decode_s, transfer_s, compute_s)
    print(json.dumps({
        "platform": jax.devices()[0].platform,
        "shape": [BATCH, H, W],
        "decode_mps": round(mp_batch / decode_s, 1),
        "transfer_mps": round(mp_batch / transfer_s, 1),
        "compute_mps": round(mp_batch / compute_s, 1),
        "e2e_serial_mps": round(mp_batch / serial, 1),
        "e2e_overlapped_bound_mps": round(mp_batch / overlapped, 1),
        "binding_stage": max(
            (("decode", decode_s), ("transfer", transfer_s),
             ("compute", compute_s)), key=lambda kv: kv[1],
        )[0],
    }))


if __name__ == "__main__":
    main()
