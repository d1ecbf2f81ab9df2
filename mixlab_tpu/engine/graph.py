"""Workspace graph: modules, connections, type-checked patching.

Rebuild of the reference's workspace layer (``src/engine/workspace.rs``):
``connect`` enforces line-type equality (workspace.rs:97-114), persistence
mirrors ``persist::Workspace`` (``src/persist.rs:9-21``), and run order uses
the same terminal-module DFS as the reference's per-tick scheduler
(``src/engine.rs:400-457``) — except this build computes it once per
*edit*, not per tick, because the compiled program is reused until the graph
changes.

Cycle semantics are reproduced exactly: the DFS seen-set breaks cycles, and a
back-edge input reads a buffer that has not been produced in this program,
which the compiler lowers to zeros (engine.rs:478-483); a graph that is only
a cycle has no terminal module and never runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from mixlab_tpu.dsp.registry import get_def
from mixlab_tpu.protocol import (
    Indication,
    InputId,
    LineType,
    ModuleId,
    ModuleParams,
    OutputId,
    Terminal,
    WindowGeometry,
)


class ConnectError(Exception):
    pass


class NoInput(ConnectError):
    pass


class NoOutput(ConnectError):
    pass


class TypeMismatch(ConnectError):
    pass


@dataclass
class ModuleEntry:
    params: ModuleParams
    inputs: List[Terminal]
    outputs: List[Terminal]


@dataclass
class Workspace:
    module_seq: int = 0
    modules: Dict[ModuleId, ModuleEntry] = field(default_factory=dict)
    geometry: Dict[ModuleId, WindowGeometry] = field(default_factory=dict)
    connections: Dict[InputId, OutputId] = field(default_factory=dict)
    indications: Dict[ModuleId, Indication] = field(default_factory=dict)

    # -- editing ----------------------------------------------------------

    def create_module(
        self, params: ModuleParams, geometry: WindowGeometry = WindowGeometry()
    ) -> ModuleId:
        self.module_seq += 1
        mid = ModuleId(self.module_seq)
        d = get_def(params.kind)
        ins, outs = d.terminals(params.params)
        self.modules[mid] = ModuleEntry(params, list(ins), list(outs))
        self.geometry[mid] = geometry
        self.indications[mid] = Indication(params.kind, None)
        return mid

    def snapshot(self) -> "Workspace":
        """Cheap structural copy for transactional op application.

        The engine takes one before applying a client op and rolls back on
        failure (engine thread must survive ANY op — the reference gets the
        equivalent guarantee from Rust's type system keeping malformed ops
        unrepresentable; see wire.WireDecodeError for the decode half).
        ModuleEntry params objects are immutable-by-convention (replaced,
        never mutated), so a per-entry shallow copy suffices.
        """
        return Workspace(
            module_seq=self.module_seq,
            modules={
                mid: ModuleEntry(e.params, list(e.inputs), list(e.outputs))
                for mid, e in self.modules.items()
            },
            geometry=dict(self.geometry),
            connections=dict(self.connections),
            indications=dict(self.indications),
        )

    def restore(self, snap: "Workspace") -> None:
        """Adopt a snapshot's state in place (rollback of a failed op)."""
        self.module_seq = snap.module_seq
        self.modules = snap.modules
        self.geometry = snap.geometry
        self.connections = snap.connections
        self.indications = snap.indications

    def update_params(self, mid: ModuleId, params: ModuleParams) -> bool:
        entry = self.modules.get(mid)
        if entry is None:
            return False
        if params.kind != entry.params.kind:
            raise ValueError("module params kind mismatch")
        d = get_def(params.kind)
        ins, outs = d.terminals(params.params)
        entry.params = params
        entry.inputs = list(ins)
        entry.outputs = list(outs)
        # drop connections that no longer type-check (e.g. mixer channel
        # count reduced)
        for input_id in list(self.connections):
            if input_id.module_id == mid:
                if input_id.index >= len(entry.inputs):
                    del self.connections[input_id]
        return True

    def delete_module(self, mid: ModuleId) -> List[InputId]:
        """Returns deleted connection input ids (engine.rs:324-358)."""
        deleted = [
            input_id
            for input_id, output_id in self.connections.items()
            if input_id.module_id == mid or output_id.module_id == mid
        ]
        for input_id in deleted:
            del self.connections[input_id]
        self.modules.pop(mid, None)
        self.geometry.pop(mid, None)
        self.indications.pop(mid, None)
        return deleted

    def terminal_type(self, tid) -> Optional[LineType]:
        if isinstance(tid, InputId):
            entry = self.modules.get(tid.module_id)
            if entry and tid.index < len(entry.inputs):
                return entry.inputs[tid.index].line_type
        elif isinstance(tid, OutputId):
            entry = self.modules.get(tid.module_id)
            if entry and tid.index < len(entry.outputs):
                return entry.outputs[tid.index].line_type
        return None

    def connect(self, input_id: InputId, output_id: OutputId) -> Optional[OutputId]:
        """Type-checked connect; returns the replaced connection if any
        (workspace.rs:97-114)."""
        in_ty = self.terminal_type(input_id)
        if in_ty is None:
            raise NoInput(str(input_id))
        out_ty = self.terminal_type(output_id)
        if out_ty is None:
            raise NoOutput(str(output_id))
        if in_ty != out_ty:
            raise TypeMismatch(f"{in_ty} != {out_ty}")
        prev = self.connections.get(input_id)
        self.connections[input_id] = output_id
        return prev

    def disconnect(self, input_id: InputId) -> Optional[OutputId]:
        return self.connections.pop(input_id, None)

    # -- scheduling -------------------------------------------------------

    def run_order(self) -> List[ModuleId]:
        """Terminal-module DFS topo order (engine.rs:400-457).

        Deterministic: terminals and inputs are visited in sorted id order
        (the reference iterates a HashSet — arbitrary order — but dataflow
        makes results order-independent; we pick a canonical order)."""
        consumed = {out.module_id for out in self.connections.values()}
        terminals = sorted(
            (mid for mid in self.modules if mid not in consumed),
            key=lambda m: m.value,
        )

        order: List[ModuleId] = []
        seen = set()

        def traverse(mid: ModuleId):
            if mid in seen:
                return
            seen.add(mid)
            entry = self.modules[mid]
            for i in range(len(entry.inputs)):
                out = self.connections.get(InputId(mid, i))
                if out is not None and out.module_id in self.modules:
                    traverse(out.module_id)
            order.append(mid)

        for mid in terminals:
            traverse(mid)
        return order

    # -- persistence (persist.rs:9-21) ------------------------------------

    def to_persist(self) -> dict:
        from mixlab_tpu.protocol import wire

        return {
            "module_seq": self.module_seq,
            "modules": {
                str(mid.value): {
                    "params": wire.encode(entry.params),
                    "geometry": wire.encode(self.geometry.get(mid, WindowGeometry())),
                    "inputs": [
                        (
                            [out.module_id.value, out.index]
                            if (out := self.connections.get(InputId(mid, i)))
                            else None
                        )
                        for i in range(len(entry.inputs))
                    ],
                }
                for mid, entry in self.modules.items()
            },
        }

    @staticmethod
    def from_persist(save: dict) -> "Workspace":
        from mixlab_tpu.protocol import wire

        ws = Workspace(module_seq=save.get("module_seq", 0))
        # create modules first, then connect (workspace.rs:22-56)
        for mid_str, saved in save.get("modules", {}).items():
            mid = ModuleId(int(mid_str))
            params = wire.decode_module_params(saved["params"])
            d = get_def(params.kind)
            ins, outs = d.terminals(params.params)
            ws.modules[mid] = ModuleEntry(params, list(ins), list(outs))
            ws.geometry[mid] = wire._decode_typed(saved["geometry"], WindowGeometry)
            ws.indications[mid] = Indication(params.kind, None)
        for mid_str, saved in save.get("modules", {}).items():
            mid = ModuleId(int(mid_str))
            for i, out in enumerate(saved.get("inputs", [])):
                if out is not None:
                    try:
                        ws.connect(
                            InputId(mid, i), OutputId(ModuleId(out[0]), out[1])
                        )
                    except ConnectError:
                        pass  # ignore, matching workspace.rs:47-50
        return ws
