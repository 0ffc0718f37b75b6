"""Multi-device data-parallel pipeline: shard_map over a read axis + psum merge.

This is the rebuild's distributed layer (SURVEY.md §2.2/§2.3 — the reference
has NO distributed anything; the spec here comes from BASELINE.json's north
star): read batches are sharded over the ``data`` mesh axis, every device runs
the identical banded-DP + rescoring program on its shard, and the per-locus
log-likelihood accumulators merge with a single ``psum`` — the only
cross-device communication in the whole pipeline.

The per-device program IS :func:`nadavca_tpu.pipeline.device_compute` — the
same body the single-device ``_device_step`` jits (with the cuda backend,
the fill/backtrack/rescore custom calls run inside shard_map unchanged), so
the single-device and multi-device paths cannot diverge; the scatter
semantics come from
:func:`nadavca_tpu.call.scatter_values`, shared with ``accumulate_batch``.

Accumulator layouts:
  * replicated (default): every device holds (G, 4); one psum per batch.
  * genome-sharded (config 4, large G): each device keeps only its G/n slice;
    the batch's contribution is merged by ``psum_scatter`` along the genome
    axis, so no device ever materializes the full accumulator.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import AlignConfig
from .. import call as callmod
from .. import pipeline as pipelinemod

# stage_batch keys that are NOT sharded over the read axis
_REPLICATED_KEYS = ("lm", "ls")
_META_KEYS = ("backend", "k")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _spec_for(key: str, axis: str) -> P:
    if key in _REPLICATED_KEYS:
        return P()
    return P(axis)


def shard_staged(mesh: Mesh, cfg: AlignConfig, staged: dict) -> dict:
    """device_put the per-batch staged arrays with their mesh shardings.

    Metadata keys pass through; replicated constants (model tables) are
    also put here — device_put is a no-op when the array already has the
    right sharding, so per-batch calls only move the batch data.
    """
    out = {}
    for k, v in staged.items():
        if k in _META_KEYS:
            out[k] = v
        else:
            out[k] = jax.device_put(v, NamedSharding(mesh, _spec_for(k, cfg.data_axis)))
    return out


def make_sharded_step(
    mesh: Mesh,
    cfg: AlignConfig,
    genome_len: int,
    backend: str = "scan",
    k: int = 6,
    genome_sharded: bool = False,
    with_path: bool = True,
    merge_deferred: bool = False,
):
    """Build the jitted multi-device align+accumulate step.

    The returned fn consumes the staged-array dict from
    :func:`nadavca_tpu.pipeline.stage_batch` (plus ``wstart``/``wlen``/
    ``strand`` window metadata) and the accumulators:

      step(staged, wstart, wlen, strand, acc, cov, votes)
        -> (score, path, acc, cov, votes)        # with_path=True
        -> (score, acc, cov, votes)              # with_path=False

    ``with_path=False`` drops the (R, T) Viterbi path from the outputs — the
    SNP loop never reads it, and materializing it costs an R·T·4-byte
    device-memory write per batch (21 MB at R=512, T=10,240).

    ``merge_deferred=True`` removes the per-batch collective entirely: each
    device carries a FULL-genome partial accumulator (global arrays are
    (n_dev·G, 4)-shaped, P(data)-sharded; see make_accumulators_sharded)
    and the step just adds its local contribution — the single psum /
    psum_scatter moves to :func:`make_merge_fn`, run only at checkpoints
    and before calling. Rationale: the per-batch merge payload is G·36
    bytes (166 MB at a 4.6 Mb genome), while the merged state is only ever
    consumed at checkpoint/call time, so per-batch merging is pure
    overhead; deferring it makes the collective cost O(merges), not
    O(batches). The trade is G·36 bytes of device memory per device for
    the partial (the same three arrays: 166 MB at 4.6 Mb), so callers fall
    back to per-batch merging for genomes too large to replicate (the
    genome-sharded regime's reason to exist).
    """
    axis = cfg.data_axis
    G = genome_len
    n_dev = mesh.devices.size
    if genome_sharded and G % n_dev != 0:
        raise ValueError(f"genome_len {G} not divisible by mesh size {n_dev}")

    data = P(axis)
    repl = P()
    if merge_deferred:
        acc_spec = data                   # per-device full-G partials
    else:
        acc_spec = P(axis) if genome_sharded else repl

    staged_specs = {k2: _spec_for(k2, axis)
                    for k2 in pipelinemod.STAGED_ARRAYS}

    out_specs = ((data, data, acc_spec, acc_spec, acc_spec) if with_path
                 else (data, acc_spec, acc_spec, acc_spec))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(staged_specs, data, data, data, acc_spec, acc_spec, acc_spec),
        out_specs=out_specs,
        check_vma=False,
    )
    def step(staged, wstart, wlen, strand, acc, cov, votes):
        score, path, base_ll = pipelinemod.device_compute(
            *(staged[k2] for k2 in pipelinemod.STAGED_ARRAYS),
            cfg=cfg, backend=backend, k=k,
        )
        flat, ll, n_valid, onehot = callmod.scatter_values(
            base_ll, wstart, wlen, strand, G, cfg)
        dacc = jnp.zeros((G + 1, 4), jnp.float32).at[flat].add(ll)[:G]
        dcov = jnp.zeros((G + 1,), jnp.int32).at[flat].add(n_valid)[:G]
        dvotes = jnp.zeros((G + 1, 4), jnp.int32).at[flat].add(onehot)[:G]
        if merge_deferred:
            # no collective: the local full-G partial just grows; the merge
            # happens in make_merge_fn at checkpoint/finalize time
            pass
        elif genome_sharded:
            # each device keeps its genome slice of the merged contribution
            dacc = jax.lax.psum_scatter(
                dacc.reshape(n_dev, G // n_dev, 4), axis, scatter_dimension=0,
                tiled=False,
            )
            dcov = jax.lax.psum_scatter(
                dcov.reshape(n_dev, G // n_dev), axis, scatter_dimension=0,
                tiled=False,
            )
            dvotes = jax.lax.psum_scatter(
                dvotes.reshape(n_dev, G // n_dev, 4), axis, scatter_dimension=0,
                tiled=False,
            )
        else:
            dacc = jax.lax.psum(dacc, axis)
            dcov = jax.lax.psum(dcov, axis)
            dvotes = jax.lax.psum(dvotes, axis)
        if with_path:
            return score, path, acc + dacc, cov + dcov, votes + dvotes
        return score, acc + dacc, cov + dcov, votes + dvotes

    return jax.jit(step, donate_argnums=(4, 5, 6))


def make_sharded_align(
    mesh: Mesh,
    cfg: AlignConfig,
    backend: str = "scan",
    k: int = 6,
):
    """Multi-device align-only step (no accumulators): staged -> (score, path).

    Same device_compute body as make_sharded_step; used by ``cli align
    --devices N`` where per-read paths are the output.
    """
    axis = cfg.data_axis
    data = P(axis)
    staged_specs = {k2: _spec_for(k2, axis)
                    for k2 in pipelinemod.STAGED_ARRAYS}

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(staged_specs,),
        out_specs=(data, data, data),
        check_vma=False,
    )
    def step(staged):
        return pipelinemod.device_compute(
            *(staged[k2] for k2 in pipelinemod.STAGED_ARRAYS),
            cfg=cfg, backend=backend, k=k,
        )

    return jax.jit(step)


def make_accumulators_sharded(mesh: Mesh, cfg: AlignConfig, genome_len: int,
                              genome_sharded: bool = False,
                              merge_deferred: bool = False):
    """Device accumulators with the right sharding for make_sharded_step.

    ``merge_deferred``: per-device FULL-genome partials — global shape
    (n_dev·G, ...) sharded P(data); merge with :func:`make_merge_fn`.
    """
    if merge_deferred:
        n = mesh.devices.size
        sh = NamedSharding(mesh, P(cfg.data_axis))
        acc = jax.device_put(jnp.zeros((n * genome_len, 4), jnp.float32), sh)
        cov = jax.device_put(jnp.zeros((n * genome_len,), jnp.int32), sh)
        votes = jax.device_put(jnp.zeros((n * genome_len, 4), jnp.int32), sh)
        return acc, cov, votes
    spec = P(cfg.data_axis) if genome_sharded else P()
    sh = NamedSharding(mesh, spec)
    acc = jax.device_put(jnp.zeros((genome_len, 4), jnp.float32), sh)
    cov = jax.device_put(jnp.zeros((genome_len,), jnp.int32), sh)
    votes = jax.device_put(jnp.zeros((genome_len, 4), jnp.int32), sh)
    return acc, cov, votes


def make_merge_fn(mesh: Mesh, cfg: AlignConfig, genome_len: int,
                  genome_sharded: bool = False):
    """The deferred merge: (n_dev·G, ...) P(data) partials → the exact
    accumulator layout the per-batch-merge mode maintains (replicated, or
    genome-sharded slices). Pure — partials are left untouched, so it can
    run at every checkpoint and again at finalize."""
    axis = cfg.data_axis
    G = genome_len
    n_dev = mesh.devices.size
    out_spec = P(axis) if genome_sharded else P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(out_spec, out_spec, out_spec),
        check_vma=False,
    )
    def merge(acc, cov, votes):
        if genome_sharded:
            return (
                jax.lax.psum_scatter(acc.reshape(n_dev, G // n_dev, 4),
                                     axis, scatter_dimension=0, tiled=False),
                jax.lax.psum_scatter(cov.reshape(n_dev, G // n_dev),
                                     axis, scatter_dimension=0, tiled=False),
                jax.lax.psum_scatter(votes.reshape(n_dev, G // n_dev, 4),
                                     axis, scatter_dimension=0, tiled=False),
            )
        return (jax.lax.psum(acc, axis), jax.lax.psum(cov, axis),
                jax.lax.psum(votes, axis))

    return jax.jit(merge)


def shard_batch_arrays(mesh: Mesh, cfg: AlignConfig, arrays: dict):
    """device_put batch arrays with leading-dim sharding over the data axis."""
    sh = NamedSharding(mesh, P(cfg.data_axis))
    return {k: jax.device_put(v, sh) for k, v in arrays.items()}
