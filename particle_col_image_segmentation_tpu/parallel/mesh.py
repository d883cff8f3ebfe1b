"""Device-mesh construction.

The reference has zero parallelism (SURVEY.md §2.8); scale-out here is a
2-axis mesh with "data" (batch of planes — the DP axis) and "space" (plane
rows — the spatial/TP-analogue axis).  The devices of one host are joined
all to all (NVLink), so any device order is a valid layout within a host;
only the split between hosts matters (see ``initialize_multihost``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(
    n_data: Optional[int] = None,
    n_space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over ``n_data × n_space`` devices (defaults to all devices on the
    data axis)."""
    devices = list(devices if devices is not None else jax.devices())
    derived = n_data is None
    if n_data is None:
        n_data = len(devices) // n_space
    use = n_data * n_space
    if use == 0 or use > len(devices) or (derived and use != len(devices)):
        # an empty/oversubscribed mesh fails opaquely later inside
        # shard_map, and a DERIVED n_data silently dropping the remainder
        # devices runs the job degraded with no signal
        raise ValueError(
            f"mesh {n_data}×{n_space} needs {use or n_space} devices, have "
            f"{len(devices)} — pick axis sizes that divide the device count "
            "(or pass explicit n_data for an intentional subset)"
        )
    if use < len(devices):  # explicit subset: allowed, but never silent
        import logging

        logging.getLogger(__name__).info(
            "mesh %d×%d uses %d of %d devices", n_data, n_space, use,
            len(devices),
        )
    arr = np.array(devices[:use]).reshape(n_data, n_space)
    return Mesh(arr, (DATA_AXIS, SPACE_AXIS))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """Multi-host entry point (SURVEY §2.8: meshes spanning hosts).

    Calls ``jax.distributed.initialize`` (with the given coordinator, or
    auto-detecting a managed cluster when no arguments are given), then
    builds the global mesh over every device — data-parallel across hosts
    (batch stays host-local through the loader), spatial axis within each
    host so halo exchange stays on the intra-host links, never the network.
    Single-process environments skip initialization and return the local
    mesh.
    """
    if coordinator_address is not None or num_processes not in (None, 1):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif num_processes is None:
        try:  # cluster auto-detection (fails outside a managed cluster)
            jax.distributed.initialize()
        except Exception as e:  # noqa: BLE001 — single-host fallback is the point
            # ... but a REAL cluster bring-up failure (coordinator timeout,
            # runtime mismatch) must not silently become a single-host run
            import logging

            logging.getLogger(__name__).warning(
                "jax.distributed.initialize() auto-detect failed (%s: %s) — "
                "continuing single-host; on a multi-host cluster this is a "
                "bring-up failure, not the intended fallback",
                type(e).__name__, e,
            )
    # group devices by host so each mesh row is one process: the spatial
    # axis (per-iteration ppermute halos in the CCL/watershed fixpoints)
    # must stay within a host, never cross the network — raw
    # jax.devices() id order is not guaranteed host-contiguous
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    total = len(devs)
    n_space = min(jax.local_device_count(), total)
    return make_mesh(n_data=total // n_space, n_space=n_space, devices=devs)
