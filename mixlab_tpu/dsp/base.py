"""Module definition interface for the device DSP layer.

Re-design of the reference's ``ModuleT`` trait
(``src/module/mod.rs:7-19`` in haileys/mixlab).  Where the reference runs a
stateful object per tick with borrowed buffers, this build lowers every
module to a *pure function over a block of ticks*:

    run_block(aux, host_aux, state, inputs, cfg, block)
        -> (state', outputs, taps)

and the graph compiler (:mod:`mixlab_tpu.engine.compiler`) composes all
modules of a patch into ONE jitted program.  State (filter poles, envelope
phase, ...) is an explicit pytree carry, which also makes runtime DSP state
checkpointable — something the reference cannot do (its persistence only
saves declarative params, ``src/persist.rs:9-21``).

Data conventions (device):
  * mono buffer:   f32 ``[S]``        (S = block samples)
  * stereo buffer: TUPLE ``(L, R)`` of two f32 ``[S]`` mono arrays
  * video:         handled by the host video engine, not through run_block

Stereo-as-a-pair is the channel-major layout taken to its end point: an
``[S, 2]`` array forces a materialized stack/unstack at every
panner/splitter/oscillator boundary.  As a pair of ``[S]`` arrays, channel
routing (panner, splitter, mono->stereo fanout) is pure pytree plumbing with
ZERO device ops, duplicated channels (an oscillator's L==R) are a single
traced value XLA computes once, and every elementwise module body is a
contiguous ``[S]`` kernel.  Stereo crosses to the host (taps, ext feeds) as
channel-major ``[2, ...]`` arrays; hosts convert with one numpy transpose.

``aux`` is a pytree of *traced* device values derived from params at edit
time — continuous params (gains, frequencies) live here so that slider drags
do NOT trigger recompilation.  Structural params (waveform, channel count)
are baked into the trace and recompile on change (human-rate, acceptable).

``host_aux`` is a pytree of per-dispatch host-prepared arrays (e.g. per-tick
oscillator phase bases computed in float64 on host for precision) — see
``host_prepare``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import Terminal

Array = Any  # jax array
Pytree = Any


class ModuleDef:
    """One module kind. Stateless singleton; all data flows through args."""

    kind: str = "?"

    # -- structure ---------------------------------------------------------
    def terminals(self, params) -> Tuple[List[Terminal], List[Terminal]]:
        """(inputs, outputs), mirroring ModuleT::inputs/outputs."""
        raise NotImplementedError

    # -- device state ------------------------------------------------------
    def init_state(self, params, cfg: EngineConfig) -> Pytree:
        """Initial carried DSP state (or None)."""
        return None

    def carry_state(self, old_state: Pytree, params, cfg: EngineConfig) -> Pytree:
        """State carried across a params edit.  Default: keep (matches e.g.
        eq_three keeping filter poles on gain change, eq_three.rs:53-56).
        Modules that reset on edit override this."""
        return old_state

    # -- param lowering ----------------------------------------------------
    def structural_key(self, params) -> Any:
        """Hashable fingerprint of the *structural* parts of params (things
        baked into the trace: waveform, channel count...).  A param edit that
        keeps the structural key only swaps ``aux`` values — no recompile; a
        change to the key rebuilds the compiled program."""
        return None

    def prepare(self, params, cfg: EngineConfig) -> Pytree:
        """Traced device values derived from params (recomputed per edit,
        passed as jit arguments so param tweaks don't recompile)."""
        return None

    def host_prepare(
        self, params, t0: int, block: BlockSpec, cfg: EngineConfig
    ) -> Pytree:
        """Cheap per-dispatch host computation (numpy), e.g. float64 phase
        bases.  ``t0`` is the absolute sample index of the block start (exact
        Python int)."""
        return None

    # -- compute -----------------------------------------------------------
    def run_block(
        self,
        params: Any,
        aux: Pytree,
        host_aux: Pytree,
        state: Pytree,
        inputs: Sequence[Optional[Array]],
        cfg: EngineConfig,
        block: BlockSpec,
    ) -> Tuple[Pytree, List[Optional[Array]], Dict[str, Array]]:
        """Pure block kernel.  ``inputs[i]`` is None iff input i is
        unconnected (reference semantics: expect_mono/expect_stereo read a
        static zero buffer for Disconnected, io.rs:8-9,36-52 — helpers below
        reproduce that; but modules that check ``connected()`` can
        distinguish).

        ``params`` is the raw params object; ONLY parts covered by
        ``structural_key`` may influence the trace — continuous values must
        be read from ``aux`` (traced) so edits don't recompile."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# input helpers mirroring InputRef::expect_* zero-fill semantics
# ---------------------------------------------------------------------------


def expect_mono(x: Optional[Array], S: int, dtype=np.float32) -> Array:
    import jax.numpy as jnp

    if x is None:
        return jnp.zeros((S,), dtype=dtype)
    return x


def interleave_tap(pair) -> np.ndarray:
    """Host-side: convert a channel-major stereo tap — an ``(L, R)`` pair of
    ``[..., spt]`` arrays — to interleaved ``[..., 2]`` numpy."""
    l, r = pair
    return np.stack([np.asarray(l), np.asarray(r)], axis=-1)


def expect_stereo(
    x: Optional[Tuple[Array, Array]], S: int, dtype=np.float32
) -> Tuple[Array, Array]:
    """Stereo input with zero-fill semantics.  Returns the ``(L, R)`` pair;
    an unconnected input reads ONE zeros array aliased to both channels
    (XLA materializes it once, as the reference's shared static zero buffer
    is, io.rs:8-9)."""
    import jax.numpy as jnp

    if x is None:
        z = jnp.zeros((S,), dtype=dtype)
        return (z, z)
    return x
