"""Multi-host initialization.

Replaces the reference's NodeManager bring-up (dshmachines parsing +
MASTERUP/WORKERUP ZMQ handshake, nodemanager.cpp:19-107) with
jax.distributed: each host runs the same program, the coordinator is host 0,
and membership/barrier are provided by the runtime. Pass
coordinator_address/num_processes/process_id explicitly (the analog of the
dshmachines file's line-per-node contract); without them JAX's own cluster
auto-detection is tried.

Usage (one process per host):
    from dorylus_tpu.parallel.multihost import init_multihost, global_mesh
    init_multihost("host0:1234", 4, rank)
    mesh = global_mesh()          # 'graph' axis over ALL devices
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from dorylus_tpu.parallel.mesh import GRAPH_AXIS


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize the cross-host runtime. No-op if already initialized.

    Must run before ANY backend use — even jax.process_count() initializes
    the backend and would make jax.distributed.initialize fail afterwards
    (so we check the distributed client directly, not process_count()).
    With explicit arguments, failures propagate: a half-joined cluster must
    not silently fall back to single-process (tests/test_multiprocess.py
    covers the real two-process path).
    """
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return
    import os
    try:
        jax.distributed.initialize()  # JAX's cluster auto-detection
    except (ValueError, RuntimeError):
        # Single-host environments without cluster metadata fall back
        # quietly — but when the environment SAYS this is a cluster (a
        # coordinator address), a bring-up failure must not silently
        # degrade to single-process (each host would train alone).
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            raise


def global_mesh(n: Optional[int] = None) -> Mesh:
    """Mesh over all (or the first n) global devices on the 'graph' axis.
    Device order follows jax.devices(): hosts-major, so contiguous vertex
    shards land on the same host first — halo exchange prefers the
    in-host links over the network, matching the reference's intra- vs
    inter-node traffic split."""
    devs = jax.devices()
    n = n or len(devs)
    return Mesh(np.array(devs[:n]), (GRAPH_AXIS,))
