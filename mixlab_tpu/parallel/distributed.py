"""Multi-host (DCN) scale-out: distributed bring-up + global meshes.

The reference is single-process/single-host (SURVEY §2.11); round 1 scaled
over the chips of ONE host via ``shard_map`` on a local mesh
(parallel/stems.py).  This module is the multi-host story: the SAME
shard_map programs run unchanged over a GLOBAL mesh spanning hosts —
XLA routes intra-host collective hops over the card-to-card links and inter-host hops over
DCN; no code changes at the call sites.

Bring-up mirrors the standard JAX multi-controller recipe:

  * every host runs the same program;
  * ``bring_up(coordinator, num_processes, process_id)`` initializes the
    distributed runtime (coordination service on process 0) and returns a
    global mesh over ALL devices;
  * host-local inputs become global sharded arrays via
    ``host_local_to_global`` (each host contributes its slice of e.g. the
    stems axis);
  * results needing host-side consumption are fetched per host with
    ``global_to_host_local``.

Fleet serving (many independent sessions across hosts) needs no
collectives at all: ``fleet_owner`` statically assigns sessions to
processes; each host runs its sessions' engines on its local chips and
ordinary networking (the existing server stack) faces the clients.

Tested for real in tests/test_distributed.py: two separate processes with
4 virtual CPU devices each form one 8-device global mesh and produce
psum-reduced results identical to a single-process run (the CPU backend's
Gloo collectives stand in for DCN).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


def bring_up(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    axis: str = "stems",
):
    """Initialize the JAX distributed runtime and return the global mesh.

    Call once per process before any other JAX API touches the backend.
    On a cluster the three arguments come from the deployment environment
    (e.g. hostnames file / scheduler); jax auto-detects on some managed clusters
    when called with no arguments."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return global_mesh(axis)


def global_mesh(axis: str = "stems"):
    """Mesh over every device of every participating host."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()  # global view in multi-controller JAX
    return Mesh(np.array(devs), (axis,))


def host_local_to_global(x, mesh, spec=None):
    """Each host contributes its local shard of ``x`` along the mesh axis;
    returns the logically-global array."""
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    spec = spec if spec is not None else P(mesh.axis_names[0])
    return mhu.host_local_array_to_global_array(x, mesh, spec)


def global_to_host_local(x, mesh, spec=None):
    """Fetch this host's portion of a global array for host-side use."""
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    spec = spec if spec is not None else P(mesh.axis_names[0])
    return mhu.global_array_to_host_local_array(x, mesh, spec)


def fleet_owner(session_id: int, num_processes: int) -> int:
    """Static session->host assignment for fleet serving (no collectives:
    each session's engine lives wholly on one host's chips)."""
    return session_id % num_processes


def distributed_stems_step(ws, cfg, block, mesh, monitor_key: str):
    """The stems shard_map program from parallel/stems.py, unchanged, over
    a (possibly multi-host) mesh — demonstrating that the single-host and
    DCN paths are the same compiled program."""
    from mixlab_tpu.parallel.stems import stem_parallel_step

    return stem_parallel_step(ws, cfg, block, mesh, monitor_key)
