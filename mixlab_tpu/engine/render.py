"""Offline render driver.

Renders a workspace graph for N ticks in large blocks, collecting taps
(monitor audio, plotter scopes...).  This is the replacement for
letting the realtime engine free-run: one jitted dispatch covers
``block.n_ticks`` ticks, and consecutive dispatches carry DSP state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import numpy as np

from mixlab_tpu.dsp.base import interleave_tap
from mixlab_tpu.engine.compiler import CompiledPatch, compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace


@dataclass
class RenderResult:
    ticks: int
    # mid key -> tap name -> np.ndarray concatenated over blocks
    taps: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)

    def tap(self, mid, name: str) -> Optional[np.ndarray]:
        k = str(mid.value) if hasattr(mid, "value") else str(mid)
        return self.taps.get(k, {}).get(name)

    def monitor_audio(self, mid) -> Optional[np.ndarray]:
        """Monitor tap as [samples, 2] f32."""
        a = self.tap(mid, "audio")
        if a is None:
            return None
        return a.reshape(-1, a.shape[-1])


def render(
    ws: Workspace,
    n_ticks: int,
    cfg: EngineConfig = EngineConfig(),
    block_ticks: int = 60,
    t0: int = 0,
    ext_feeds_fn=None,
    collect: bool = True,
) -> RenderResult:
    """Render ``n_ticks`` ticks offline.

    ``ext_feeds_fn(t0, block) -> ext_feeds`` optionally supplies host audio
    for stream_input/media_source modules per dispatch.
    """
    block = BlockSpec(min(block_ticks, n_ticks))
    patch = compile_patch(ws, cfg, block)
    aux = patch.prepare_aux(ws)
    state = patch.init_state(ws)

    collected: Dict[str, Dict[str, List[np.ndarray]]] = {}
    done = 0
    t = t0
    while done < n_ticks:
        todo = min(block.n_ticks, n_ticks - done)
        if todo != block.n_ticks:
            # tail block with a different static size: recompile once
            block = BlockSpec(todo)
            patch = compile_patch(ws, cfg, block)
            aux = patch.prepare_aux(ws)
        ext = ext_feeds_fn(t, block) if ext_feeds_fn else None
        host_aux = patch.host_aux(t, ext)
        state, taps = patch.run(aux, host_aux, state)
        if collect:
            for k, tp in taps.items():
                dest = collected.setdefault(k, {})
                for name, arr in tp.items():
                    if isinstance(arr, tuple):  # channel-major stereo pair
                        arr = interleave_tap(arr)
                    dest.setdefault(name, []).append(np.asarray(arr))
        done += todo
        t += todo * cfg.samples_per_tick

    result = RenderResult(ticks=n_ticks)
    for k, tp in collected.items():
        result.taps[k] = {
            name: np.concatenate(chunks, axis=0) if chunks[0].ndim > 0
            else np.stack(chunks)
            for name, chunks in tp.items()
        }
    return result
