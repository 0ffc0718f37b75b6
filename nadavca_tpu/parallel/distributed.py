"""Multi-host execution: process groups, per-host ingest, global merge.

Rebuild of BASELINE.json config 5 (the reference has no distributed layer —
SURVEY.md §2.3): each host runs ``jax.distributed.initialize`` to join the
process group, streams its own shard of the fast5/pod5 inputs (shared-nothing
ingest), runs the data-parallel align+accumulate step over the global mesh
(XLA routes the psum over NVLink within a host and the network across
hosts), and the final
accumulators are fetched on process 0 for VCF writing. Processes that share
a host drive one card each (see :func:`initialize_distributed`).

Testable without a cluster: N local CPU processes with a local coordinator —
scripts/multihost_demo.py drives exactly that.
"""

from __future__ import annotations

import glob
import ipaddress
import os
from typing import List, Optional, Sequence

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or create) the multi-host process group.

    Pass all three arguments: nothing in the environment describes the
    cluster. The policy is one process per card wherever the layout can be
    seen: a loopback coordinator means every process of the group runs on
    this host, so when there are several, process p opens only local GPU
    p % n_local_gpus (a JAX process reserves most of a card's memory, so
    two on one card fail). With a coordinator on the network every process
    keeps its host's cards (one process per host, which ``--devices``
    spreads over them); several processes per host then need
    ``CUDA_VISIBLE_DEVICES`` set per process. Hosts without a GPU keep
    every local device.
    """
    kwargs = {}
    if (process_id is not None and (num_processes or 1) > 1
            and is_loopback(coordinator_address)):
        n_gpu = local_gpu_count()
        if n_gpu:
            kwargs["local_device_ids"] = [process_id % n_gpu]
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_loopback(address: Optional[str]) -> bool:
    """Whether a ``host:port`` coordinator address names this host's
    loopback interface (reachable from this host only)."""
    if not address:
        return False
    host = address.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def local_gpu_count() -> int:
    """NVIDIA GPUs this host exposes, counted without initializing JAX
    (the process group must be joined before any backend starts)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    return len(glob.glob("/dev/nvidia[0-9]*"))


def shard_files_for_process(paths: Sequence[str],
                            process_id: Optional[int] = None,
                            num_processes: Optional[int] = None) -> List[str]:
    """Deterministic round-robin file assignment (shared-nothing ingest)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [p for i, p in enumerate(sorted(paths)) if i % n == pid]


def global_batch_from_local(local_arrays: dict, mesh, cfg):
    """Form globally-sharded arrays from per-host local shards.

    Each host provides its local (R_local, ...) batch; the global array is
    (R_local * n_processes, ...) sharded over the data axis with each host
    contributing its own rows — no cross-host data movement.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(cfg.data_axis))
    out = {}
    for k, v in local_arrays.items():
        global_shape = (v.shape[0] * jax.process_count(),) + v.shape[1:]
        out[k] = jax.make_array_from_process_local_data(
            sharding, np.asarray(v), global_shape
        )
    return out


def global_staged_from_local(local_arrays: dict, mesh, cfg):
    """Globally-sharded staged batch from per-host local staged arrays.

    Like :func:`global_batch_from_local` but spec-aware: model tables are
    replicated (every host passes an identical copy), everything else
    shards on the leading read axis — matching
    parallel/sharded.make_sharded_step.
    """
    from jax.sharding import NamedSharding

    from .sharded import _spec_for

    out = {}
    for k, v in local_arrays.items():
        spec = _spec_for(k, cfg.data_axis)
        sharding = NamedSharding(mesh, spec)
        v = np.asarray(v)
        if k in ("lm", "ls"):
            global_shape = v.shape
        else:
            global_shape = (v.shape[0] * jax.process_count(),) + v.shape[1:]
        out[k] = jax.make_array_from_process_local_data(
            sharding, v, global_shape
        )
    return out


def fetch_replicated(x) -> np.ndarray:
    """Materialize a global array on every host.

    Three cases: fully-addressable (single process) — plain fetch;
    replicated across processes — every device shard IS the full array, read
    the local one; sharded across processes (genome-sharded accumulators) —
    process_allgather with tiled=True reassembles the global value.
    """
    if x.is_fully_addressable:
        return np.asarray(x)
    shard = x.addressable_shards[0]
    if tuple(shard.data.shape) == tuple(x.shape):
        return np.asarray(shard.data)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
