"""Fleet serving: many independent sessions of the same patch on one chip
(or sharded over a mesh).

SURVEY §7.8: "multi-stem/multi-stream batching becomes vmap/shard_map".
A Fleet runs N independent instances of one compiled patch — same graph
topology, *per-instance* params (aux), state and host feeds — as a single
vmapped (optionally shard_mapped) program.  This is this build's answer to
running N mixlab processes: one dispatch renders a tick block for every
session in the fleet.

Param edits for one instance update its slice of the stacked aux pytree —
no recompilation, same as the single-engine aux-swap path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mixlab_tpu.engine.compiler import CompiledPatch, compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace


def _stack(trees: List[Any]) -> Any:
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)


def _cpu_device():
    try:
        return jax.local_devices(backend="cpu")[0]
    except Exception:
        return None


def _stack_np(trees: List[Any]) -> Any:
    """Stack per-instance pytrees in HOST memory (one device transfer per
    leaf at dispatch, instead of n per-instance device puts per leaf —
    n x leaves device round trips per block would dominate the serving
    loop)."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


@dataclass
class Fleet:
    """N instances of one patch, batched on the leading axis."""

    cfg: EngineConfig
    block: BlockSpec
    n: int
    patch: CompiledPatch
    _fn: Any
    aux: Any  # stacked [n, ...] (host numpy for the shared-template path)
    state: Any  # stacked [n, ...] (device-resident between blocks)
    _instance_patches: List[CompiledPatch] = None  # per-instance params views
    _reset_fn: Any = None  # jitted single-dispatch instance-state reset

    @classmethod
    def build(
        cls,
        ws: Workspace,
        n: int,
        cfg: EngineConfig = EngineConfig(),
        block: BlockSpec = BlockSpec(1),
        per_instance_params: Optional[List[Workspace]] = None,
        mesh=None,
        axis: str = "fleet",
        tap_transform=None,
    ) -> "Fleet":
        """Compile one program and stack n instances.

        ``per_instance_params``: optional list of n workspaces sharing the
        SAME structural fingerprint but different continuous params.
        ``mesh``: optional jax Mesh; instances shard over ``axis``.
        ``tap_transform``: optional device-side post-pass over the stacked
        taps pytree (e.g. f32 -> i16 PCM conversion so the serving loop
        fetches half the bytes per block).
        """
        patch = compile_patch(ws, cfg, block, jit=False)
        program = patch._fn
        if tap_transform is not None:
            inner = program

            def program(aux, host_aux, state, _inner=inner):
                st, taps = _inner(aux, host_aux, state)
                return st, tap_transform(taps)

        if per_instance_params is None:
            # identical instances share ONE patch object (host_aux memoizes
            # by patch identity; a 1024-slot boot must not compile 2048
            # per-instance views of the same workspace).  aux lives in HOST
            # memory: per-instance edits are then plain numpy writes instead
            # of one eager device .at[].set per leaf, which at serving scale
            # means hundreds of joins x ~30 leaves of device round trips
            instance_patches = [patch] * n
            cpu = _cpu_device()
            import contextlib

            guard = (jax.default_device(cpu) if cpu is not None
                     else contextlib.nullcontext())
            with guard:
                aux = _stack_np([patch.prepare_aux(ws)] * n)
            state = _stack([patch.init_state(ws)] * n)
        else:
            sources = per_instance_params
            fingerprints = {
                compile_patch(w, cfg, block, jit=False).structural_fingerprint
                for w in sources
            }
            if fingerprints != {patch.structural_fingerprint}:
                raise ValueError(
                    "fleet instances must share the structural fingerprint")

            # per-instance param views: host_prepare (e.g. oscillator phase
            # bases) depends on each instance's own params
            instance_patches = [
                compile_patch(w, cfg, block, jit=False) for w in sources
            ]
            aux = _stack([patch.prepare_aux(w) for w in sources])
            state = _stack([patch.init_state(w) for w in sources])

        batched = jax.vmap(program)
        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            spec = P(axis)
            batched = jax.shard_map(
                jax.vmap(program),
                mesh=mesh,
                in_specs=(spec, spec, spec),
                out_specs=(spec, spec),
                check_vma=False,
            )
        fn = jax.jit(batched)
        return cls(
            cfg=cfg, block=block, n=n, patch=patch, _fn=fn, aux=aux,
            state=state, _instance_patches=instance_patches,
        )

    # -- per-instance edits (no recompile) ----------------------------------

    def update_instance_aux(self, index: int, ws: Workspace):
        """Swap one instance's continuous params (no recompilation, no
        device ops — host-memory writes; the next dispatch ships them)."""
        new_patch = compile_patch(ws, self.cfg, self.block, jit=False)
        if new_patch.structural_fingerprint != self.patch.structural_fingerprint:
            raise ValueError("instance edit changed the structural fingerprint")

        cpu = _cpu_device()
        import contextlib

        guard = (jax.default_device(cpu) if cpu is not None
                 else contextlib.nullcontext())

        def put(stacked, leaf):
            if isinstance(stacked, np.ndarray):
                stacked[index] = np.asarray(leaf)
                return stacked
            return stacked.at[index].set(jnp.asarray(leaf))

        with guard:
            # prepare_aux INSIDE the guard: its jnp scalars must land in
            # host memory — on the accelerator each one is a round trip,
            # and the numpy write-back another (~30 leaves/edit)
            new_aux = new_patch.prepare_aux(ws)
            self.aux = jax.tree.map(put, self.aux, new_aux)
        self._instance_patches[index] = new_patch

    def reset_instance_state(self, index: int, ws: Workspace):
        """Reset one instance's DSP state to init (session join/leave: a
        fresh session must not inherit the previous occupant's filter poles
        or envelope phase).  ONE jitted scatter dispatch for the whole
        state pytree instead of an eager .at[].set round trip per leaf."""
        if self._reset_fn is None:
            init1 = jax.tree.map(
                lambda x: jnp.asarray(x), self.patch.init_state(ws)
            )

            def reset(state, idx):
                return jax.tree.map(
                    lambda s, i: s.at[idx].set(i.astype(s.dtype)),
                    state, init1,
                )

            self._reset_fn = jax.jit(reset)
        self.state = self._reset_fn(self.state, jnp.int32(index))

    # -- execution -----------------------------------------------------------

    def host_aux(self, t0: int, ext_feeds_per_instance=None):
        """Per-dispatch host-prepared arrays, stacked [n, ...] in HOST
        memory (the jitted dispatch ships each stacked leaf in ONE
        transfer).  Per module: a def-provided ``host_prepare_batched``
        computes all n instances in one vectorized pass; identical-params
        modules broadcast a single compute; only genuinely heterogeneous
        modules without a batched path loop (the loop measured
        ~1 ms/instance/block — serving-scale poison)."""
        cpu = _cpu_device()
        import contextlib

        from mixlab_tpu.dsp.registry import get_def

        guard = jax.default_device(cpu) if cpu is not None else contextlib.nullcontext()
        with guard:
            if ext_feeds_per_instance:
                per = []
                for i in range(self.n):
                    ext = ext_feeds_per_instance.get(i)
                    per.append(self._instance_patches[i].host_aux(t0, ext))
                return _stack_np(per)
            out: Dict[str, Any] = {}
            base = self.patch
            for mid in base.order:
                k = str(mid.value)
                d = get_def(base._kinds[k])
                plist = [ip._params[k] for ip in self._instance_patches]
                hb = getattr(d, "host_prepare_batched", None)
                if hb is not None:
                    h = {name: np.asarray(v)
                         for name, v in (hb(plist, t0, self.block, self.cfg)
                                         or {}).items()}
                elif all(p is plist[0] for p in plist[1:]):
                    h1 = d.host_prepare(plist[0], t0, self.block, self.cfg) or {}
                    h = {name: np.broadcast_to(
                            np.asarray(v), (self.n,) + np.asarray(v).shape)
                         for name, v in h1.items()}
                else:
                    pp = [d.host_prepare(p, t0, self.block, self.cfg) or {}
                          for p in plist]
                    h = {name: np.stack([np.asarray(x[name]) for x in pp])
                         for name in pp[0]}
                spec = base._ext_specs.get(k) or {}
                for name, (shape, dtype) in spec.items():
                    h = {**h, name: np.zeros((self.n,) + tuple(shape), dtype)}
                out[k] = h if h else None
            return out

    def run_block(self, t0: int, ext_feeds_per_instance=None):
        """One dispatch for the whole fleet; returns stacked taps [n, ...]."""
        host_aux = self.host_aux(t0, ext_feeds_per_instance)
        self.state, taps = self._fn(self.aux, host_aux, self.state)
        return taps
