"""Graph compiler: workspace patch -> one jitted block program.

This replaces the reference's per-tick interpreter
(``src/engine.rs:400-510``): instead of topo-sorting and dynamically
dispatching every module every tick, the graph is compiled ONCE per edit into
a single pure function

    program(aux, host_aux, state) -> (state', taps)

that renders ``block.n_ticks`` engine ticks in one device dispatch.  XLA
fuses the whole module chain; per-module Python dispatch cost is zero at
runtime.  Parameter edits swap the traced ``aux`` pytree without
recompiling; structural edits (graph topology, waveform, channel count)
rebuild the program (human-rate, acceptable).

Reference semantics preserved:
  * run order = terminal-module DFS (engine.rs:408-457, computed per edit)
  * disconnected inputs read zeros (io.rs:8-9) — lowered to None -> zeros
  * cycle back-edges read zeros (engine.rs:478-483) — a back-edge's producer
    appears later in the run order, so its buffer is absent and lowered to
    None exactly like a disconnected input
  * absolute sample clock t = tick * samples_per_tick (engine.rs:490) — t0
    is tracked host-side as an exact Python int and enters the program only
    through per-module ``host_prepare`` arrays
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import numpy as np

from mixlab_tpu.dsp.registry import get_def
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace
from mixlab_tpu.protocol import InputId, LineType, ModuleId, OutputId


def _mid_key(mid: ModuleId) -> str:
    return str(mid.value)


@dataclass
class CompiledPatch:
    """A compiled, jitted block program for one workspace snapshot."""

    cfg: EngineConfig
    block: BlockSpec
    order: List[ModuleId]
    structural_fingerprint: Any
    _params: Dict[str, Any]  # mid key -> raw params object
    _fn: Callable  # jitted (aux, host_aux, state) -> (state, taps)
    _ext_specs: Dict[str, Dict[str, Tuple[tuple, Any]]]

    # -- per-edit / per-dispatch data -------------------------------------

    def prepare_aux(self, ws: Workspace) -> Dict[str, Any]:
        aux = {}
        for mid in self.order:
            entry = ws.modules[mid]
            d = get_def(entry.params.kind)
            aux[_mid_key(mid)] = d.prepare(entry.params.params, self.cfg)
        return aux

    def init_state(self, ws: Workspace) -> Dict[str, Any]:
        state = {}
        for mid in self.order:
            entry = ws.modules[mid]
            d = get_def(entry.params.kind)
            state[_mid_key(mid)] = d.init_state(entry.params.params, self.cfg)
        return state

    def host_aux(
        self, t0: int, ext_feeds: Optional[Dict[str, Dict[str, np.ndarray]]] = None
    ) -> Dict[str, Any]:
        """Per-dispatch host-prepared arrays.  ``ext_feeds`` carries
        host-originated audio (stream_input / media_source PCM) keyed by
        module id key; missing feeds are zero-filled."""
        out = {}
        for mid in self.order:
            k = _mid_key(mid)
            d = get_def(self._params_kind(k))
            h = d.host_prepare(self._params[k], t0, self.block, self.cfg) or {}
            spec = self._ext_specs.get(k) or {}
            if spec:
                feeds = (ext_feeds or {}).get(k, {})
                for name, (shape, dtype) in spec.items():
                    arr = feeds.get(name)
                    if arr is None:
                        arr = np.zeros(shape, dtype=dtype)
                    h = {**h, name: arr}
            out[k] = h if h else None
        return out

    def _params_kind(self, k: str) -> str:
        return self._kinds[k]

    def run(self, aux, host_aux, state):
        return self._fn(aux, host_aux, state)

    def aot_compile(self, aux, host_aux, state):
        """Trace + lower + XLA-compile without executing (jax AOT path);
        afterwards ``run`` invokes the compiled executable directly."""
        if hasattr(self._fn, "lower"):
            object.__setattr__(
                self, "_fn", self._fn.lower(aux, host_aux, state).compile()
            )


def compile_patch(
    ws: Workspace,
    cfg: EngineConfig,
    block: BlockSpec,
    jit: bool = True,
) -> CompiledPatch:
    order = ws.run_order()
    # freeze structure
    entries = {mid: ws.modules[mid] for mid in order}
    connections = dict(ws.connections)
    params_by_key = {_mid_key(m): e.params.params for m, e in entries.items()}
    kinds_by_key = {_mid_key(m): e.params.kind for m, e in entries.items()}
    ext_specs = {}
    for mid, e in entries.items():
        d = get_def(e.params.kind)
        spec = getattr(d, "ext_spec", None)
        if spec is not None:
            s = d.ext_spec(e.params.params, cfg, block)
            if s:
                ext_specs[_mid_key(mid)] = s

    fingerprint = tuple(
        (
            mid.value,
            e.params.kind,
            get_def(e.params.kind).structural_key(e.params.params),
            tuple(t.line_type for t in e.inputs),
            tuple(t.line_type for t in e.outputs),
        )
        for mid, e in entries.items()
    ) + tuple(
        sorted(
            (i.module_id.value, i.index, o.module_id.value, o.index)
            for i, o in connections.items()
        )
    )

    def program(aux, host_aux, state):
        buffers: Dict[OutputId, Any] = {}
        new_state = {}
        taps = {}
        for mid in order:
            entry = entries[mid]
            k = _mid_key(mid)
            d = get_def(entry.params.kind)
            ins: List[Optional[Any]] = []
            for i, term in enumerate(entry.inputs):
                if term.line_type == LineType.VIDEO:
                    ins.append(None)  # video flows through the host video engine
                    continue
                out_id = connections.get(InputId(mid, i))
                buf = buffers.get(out_id) if out_id is not None else None
                ins.append(buf)
            st, outs, tp = d.run_block(
                entry.params.params,
                aux[k],
                host_aux[k],
                state[k],
                ins,
                cfg,
                block,
            )
            new_state[k] = st
            if tp:
                taps[k] = tp
            for i, buf in enumerate(outs):
                if buf is not None:
                    buffers[OutputId(mid, i)] = buf
        return new_state, taps

    fn = jax.jit(program) if jit else program

    patch = CompiledPatch(
        cfg=cfg,
        block=block,
        order=order,
        structural_fingerprint=fingerprint,
        _params=params_by_key,
        _fn=fn,
        _ext_specs=ext_specs,
    )
    patch._kinds = kinds_by_key
    return patch
