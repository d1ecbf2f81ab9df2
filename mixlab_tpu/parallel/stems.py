"""Multi-chip scale-out: stem-parallel audio + row-sharded video.

The reference is a single-process, single-host system (SURVEY §2.11); its
concurrency is thread pipelining.  This build scales over a device mesh
instead:

  * **Stem parallelism** (data-parallel-like): N independent copies of a
    patch ("stems" — e.g. the 16-stem config of BASELINE config 3) run as a
    vmapped compiled program whose stem axis is sharded over the mesh's
    ``stems`` axis via ``jax.shard_map``.  A cross-stem mixdown (master sum)
    is a ``psum`` across the mesh — the replacement for the reference's
    mixer-channel loop.
  * **Spatial video sharding** (tensor-parallel-like): 1080p composite
    planes are sharded by rows across the same mesh; the crossfade blend is
    elementwise so no halo exchange is needed and XLA inserts no
    collectives on the hot path.

All functions here take an explicit ``Mesh``; tests use an 8-device virtual
CPU mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from mixlab_tpu.engine.compiler import CompiledPatch, compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace
from mixlab_tpu.video.blend import crossfade_xla


def make_mesh(n_devices: int | None = None, axis: str = "stems") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def stack_for_stems(tree: Any, n_stems: int, mesh: Mesh,
                    axis: str = "stems") -> Any:
    """Tile a per-stem pytree along a new leading stem axis, placed sharded
    over the mesh's ``axis`` (each device receives only its own stems,
    straight from the host, instead of everything landing on the first
    device and being resharded by the step).  A mesh spanning processes
    gets host values: each process contributes its own stems
    (parallel/distributed.py)."""
    return jax.tree.map(lambda x: _place(
        np.broadcast_to(np.asarray(x)[None], (n_stems,) + np.shape(x)),
        mesh, axis), tree)


def _place(x: np.ndarray, mesh: Mesh, axis: str):
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(x, sharding) if sharding.is_fully_addressable else x


def stem_parallel_step(
    ws: Workspace,
    cfg: EngineConfig,
    block: BlockSpec,
    mesh: Mesh,
    monitor_key: str,
    axis: str = "stems",
    n_stems: int | None = None,
):
    """Build a jitted multi-chip step over ``n_stems`` stems (default: one
    per device).

    ``n_stems`` need not divide the mesh: the stem axis is padded up to the
    next multiple of the device count and the pad stems are masked out of
    the mixdown (they still run — static shapes — but contribute exact
    zeros, so master equals the unpadded sum).

    Returns (fn, make_args, patch) where fn(aux, host_aux, state, mask) ->
    (state', master [T, spt, 2] mixdown summed across stems via psum).
    """
    patch = compile_patch(ws, cfg, block, jit=False)
    program = patch._fn
    n_dev = mesh.shape[axis]
    n_stems = n_dev if n_stems is None else n_stems
    n_padded = -(-n_stems // n_dev) * n_dev  # ceil to a device multiple

    def per_device(aux, host_aux, state, mask):
        # each device holds a [local_stems, ...] shard; vmap over local stems
        st, taps = jax.vmap(program)(aux, host_aux, state)
        # stereo taps are channel-major (L, R) pairs; mask pad stems, mix
        # each channel down across local stems, psum across chips,
        # then interleave once for the host-facing [T, spt, 2] master
        l, r = taps[monitor_key]["audio"]
        m = mask[:, None, None]
        master_l = jax.lax.psum((l * m).sum(axis=0), axis)
        master_r = jax.lax.psum((r * m).sum(axis=0), axis)
        return st, jnp.stack([master_l, master_r], axis=-1)

    stem_specs = P(axis)

    fn = jax.jit(
        jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(stem_specs, stem_specs, stem_specs, stem_specs),
            out_specs=(stem_specs, P()),
            check_vma=False,
        )
    )

    def make_args(t0: int = 0):
        aux = stack_for_stems(patch.prepare_aux(ws), n_padded, mesh, axis)
        host_aux = stack_for_stems(patch.host_aux(t0), n_padded, mesh, axis)
        state = stack_for_stems(patch.init_state(ws), n_padded, mesh, axis)
        mask = _place((np.arange(n_padded) < n_stems).astype(np.float32),
                      mesh, axis)
        return aux, host_aux, state, mask

    return fn, make_args, patch


class StemsPatch:
    """A CompiledPatch-shaped lowering of one workspace to ``n_stems``
    shard_mapped instances over a device mesh.

    Duck-types ``engine.compiler.CompiledPatch`` (prepare_aux / init_state /
    host_aux / run / order / structural_fingerprint), so the LIVE Engine —
    its 60 Hz loop, async compile-and-swap on structural edits, state
    carry-over, tap routing into monitor pipelines — runs multi-chip
    unmodified: pass ``Engine(patch_compiler=StemsPatch.compiler(mesh, n))``.

    Tap semantics: every stereo/mono tap leaf is a masked cross-stem
    mixdown, summed on-device per shard then ``psum``-reduced across the
    mesh — the master bus.  Pad stems (n_stems not a
    device multiple) contribute exact zeros.  Host-facing tap shapes equal
    the single-device patch's, so monitor/plotter consumers are untouched.
    """

    def __init__(self, ws: Workspace, cfg: EngineConfig, block: BlockSpec,
                 mesh: Mesh, n_stems: int | None = None, axis: str = "stems"):
        self.cfg = cfg
        self.block = block
        self.mesh = mesh
        self.axis = axis
        self._patch = compile_patch(ws, cfg, block, jit=False)
        n_dev = mesh.shape[axis]
        self.n_stems = n_dev if n_stems is None else n_stems
        self.n_padded = -(-self.n_stems // n_dev) * n_dev
        self.order = self._patch.order
        self.structural_fingerprint = (
            self._patch.structural_fingerprint,
            ("stems", self.n_stems, n_dev, axis),
        )
        program = self._patch._fn
        n_local = self.n_padded // n_dev
        n_stems_static = self.n_stems

        def per_device(aux, host_aux, state):
            st, taps = jax.vmap(program)(aux, host_aux, state)
            # mask derived from the device's position: global stem index =
            # axis_index * local + j; pads (>= n_stems) mix in exact zeros
            idx = jax.lax.axis_index(axis) * n_local + jnp.arange(n_local)
            mask = (idx < n_stems_static).astype(jnp.float32)

            def mixdown(x):
                m = mask.reshape((n_local,) + (1,) * (x.ndim - 1))
                return jax.lax.psum((x * m).sum(axis=0), axis)

            return st, jax.tree.map(mixdown, taps)

        spec = P(axis)
        # the state comes back placed exactly as prepare/init_state place it
        # (left to itself, jit may return some leaves of a one-device mesh
        # as P()), so every dispatch and the warm run share one executable
        self._fn = jax.jit(
            jax.shard_map(
                per_device,
                mesh=mesh,
                in_specs=(spec, spec, spec),
                out_specs=(spec, P()),
                check_vma=False,
            ),
            out_shardings=(NamedSharding(mesh, spec), NamedSharding(mesh, P())),
        )

    @classmethod
    def compiler(cls, mesh: Mesh, n_stems: int | None = None,
                 axis: str = "stems"):
        """-> an Engine ``patch_compiler`` closing over the mesh."""
        return lambda ws, cfg, block: cls(ws, cfg, block, mesh, n_stems, axis)

    # -- CompiledPatch interface --------------------------------------------

    def prepare_aux(self, ws: Workspace):
        return stack_for_stems(self._patch.prepare_aux(ws), self.n_padded,
                               self.mesh, self.axis)

    def init_state(self, ws: Workspace):
        return stack_for_stems(self._patch.init_state(ws), self.n_padded,
                               self.mesh, self.axis)

    def host_aux(self, t0: int, ext_feeds=None):
        # ext feeds (stream/media PCM) are shared across stems: the mixdown
        # of N copies of one ingest is N x the single feed by design
        return stack_for_stems(self._patch.host_aux(t0, ext_feeds),
                               self.n_padded, self.mesh, self.axis)

    def run(self, aux, host_aux, state):
        return self._fn(aux, host_aux, state)


def row_sharded_blend(mesh: Mesh, axis: str = "stems"):
    """Return a jitted crossfade over row-sharded planes.

    Plane heights need not divide the mesh: rows are zero-padded up to a
    device multiple before sharding and sliced back after — the blend is
    elementwise, so pad rows never leak into real output."""

    def blend(a, b, fade):
        return crossfade_xla(a, b, fade)

    n_dev = mesh.shape[axis]
    sharded = jax.jit(
        jax.shard_map(
            blend,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P()),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )

    def apply(a, b, fade):
        h = a.shape[0]
        h_pad = -(-h // n_dev) * n_dev
        if h_pad != h:
            pad = ((0, h_pad - h), (0, 0))
            a = np.pad(np.asarray(a), pad)
            b = np.pad(np.asarray(b), pad)
        sharding = NamedSharding(mesh, P(axis, None))
        a = jax.device_put(a, sharding)
        b = jax.device_put(b, sharding)
        out = sharded(a, b, jnp.asarray(fade, dtype=jnp.uint8))
        return out[:h] if h_pad != h else out

    return apply
