"""Fleet serving: N live sessions through ONE vmapped device dispatch.

The reference serves each workspace from its own OS process with its own
engine thread (src/main.rs:25-36 — one `mixlab` binary per workspace).
The case for running this framework on an accelerator is consolidation:
many sessions rendered by one card (bench.py bench_fleet_sessions measures
the device side) — but a device number is not a product.  This module is
the product shape: one process, one 60 Hz loop, one
``parallel/fleet.py`` vmapped program, serving N REAL sessions:

  * real WebSocket clients connect (``/fleet`` route), each is assigned a
    fleet slot and receives its own WorkspaceState;
  * per-session param edits arrive as ordinary WorkspaceMessage ops and are
    applied recompile-free via ``Fleet.update_instance_aux`` (the same
    optimistic Sync echo as the single-session server, server.rs:259-270);
  * per-session monitor taps (the Monitor module's audio) are fanned out to
    every session's own socket as framed i16 PCM blocks, converted on
    device so the per-block fetch ships half the bytes.

Scope (documented): fleet sessions share one graph STRUCTURE (the
structural fingerprint of ``parallel/fleet.py``); param edits are free,
structural edits require a dedicated engine (the single-session server) —
the consolidation tier serves the many-identical-sessions shape, e.g. a
hosted "preset workspace" product.  Joining resets the slot's DSP state so
a new session never inherits the previous occupant's filter poles.

The serving loop measures itself the same way the realtime engine does
(absolute deadlines, EngineStat whole-window accounting), so
``sessions_per_chip_60hz_e2e`` — the host-fan-out-inclusive fleet number
the device bench explicitly scoped out — falls out of ``/status``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from mixlab_tpu import protocol as p
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.engine import _LOST, _make_probed_worker
from mixlab_tpu.engine.graph import Workspace
from mixlab_tpu.engine.timing import EngineStat
from mixlab_tpu.parallel.fleet import Fleet
from mixlab_tpu.protocol import wire
from mixlab_tpu.server import ws as ws_mod
from mixlab_tpu.server.http import Request, read_request, response
from mixlab_tpu.server.monitor import frame_packet

log = logging.getLogger(__name__)


def _i16_taps(taps):
    """Device-side f32 [-1,1] -> i16 PCM on every tap leaf (the wire format
    of the reference's ingest/egress PCM, src/source.rs:63; halves fetch
    bytes per block)."""
    import jax
    import jax.numpy as jnp

    def conv(x):
        return (jnp.clip(x, -1.0, 1.0) * 32767.0).astype(jnp.int16)

    return jax.tree.map(conv, taps)


class _Slot:
    """One occupied fleet slot = one live session."""

    def __init__(self, index: int, ws: Workspace):
        self.index = index
        self.ws = ws
        self.joined_sample = 0  # set at join; gates in-flight fan-out
        self.monitors: List[object] = []  # _MonitorSub
        # sync/error echoes: a plain queue for direct-drive callers PLUS any
        # registered asyncio bridges (the WS handler must not burn an
        # executor thread per session polling — that caps serving at the
        # default pool size, ~32 sessions)
        self.events: "queue.Queue" = queue.Queue(maxsize=64)
        self.event_subs: List[object] = []  # _MonitorSub-shaped bridges


class _MonitorSub:
    """Bridges the engine thread to one session's asyncio websocket: the
    engine thread appends packets via loop.call_soon_threadsafe (an asyncio
    Queue is not thread-safe from the producing side), the socket task
    awaits them.  Bounded with drop-on-lag — a slow viewer loses blocks,
    never stalls the fleet (monitor.rs:164-176 semantics)."""

    DEPTH = 8

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.q: asyncio.Queue = asyncio.Queue(maxsize=self.DEPTH)
        self.dropped = 0

    def push_threadsafe(self, pkt: bytes):
        self.loop.call_soon_threadsafe(self._push, pkt)

    def _push(self, pkt: bytes):
        try:
            self.q.put_nowait(pkt)
        except asyncio.QueueFull:
            self.dropped += 1


class FleetEngine:
    """60 Hz loop over a ``parallel/fleet.py`` Fleet with live sessions.

    All device interaction happens on one probed worker thread with
    per-job timeouts; a lost op is counted in ``block_faults``.
    Joins/leaves/edits arrive through a bounded command queue and are
    applied between blocks, mirroring Engine._run's drain discipline
    (engine.rs:193-214).
    """

    def __init__(
        self,
        template: Workspace,
        capacity: int,
        cfg: EngineConfig = EngineConfig(sample_rate=48_000),
        block_ticks: int = 15,
    ):
        import jax
        import jax.numpy as jnp

        self.cfg = cfg
        self.block = BlockSpec(block_ticks)
        self.capacity = capacity
        self.template = template
        self.fleet = Fleet.build(
            template, capacity, cfg, self.block, tap_transform=_i16_taps
        )
        # Serving step: the vmapped block program PLUS a reset mask that
        # re-initializes joined/vacated slots' DSP state inside the same
        # dispatch.  Per-slot lifecycle is then pure host work instead of an
        # eager device scatter per join, which a connect storm of hundreds
        # of sessions would pay per join inside the 60 Hz loop.
        init1 = jax.tree.map(jnp.asarray,
                             self.fleet.patch.init_state(template))
        program = self.fleet.patch._fn
        n_cap = capacity

        def step(aux, host_aux, state, reset_mask):
            def put(s, i):
                m = reset_mask.reshape((n_cap,) + (1,) * (s.ndim - 1))
                return jnp.where(m, i.astype(s.dtype), s)

            state = jax.tree.map(put, state, init1)
            st, taps = jax.vmap(program)(aux, host_aux, state)
            return st, _i16_taps(taps)

        self._step = jax.jit(step)
        self._reset_mask = np.ones(capacity, dtype=bool)  # first block inits
        # issue-ahead pipeline (depth 1): block N's tap transfer overlaps
        # block N+1's compute instead of adding to it.  Costs one block of
        # monitor latency; audio continuity is unaffected (state advances on
        # dispatch, not on fetch).
        self._inflight: List = []
        # template aux row (host): vacated slots are muted back to it
        # without recompiling anything
        self._template_aux_row = jax.tree.map(
            lambda x: np.asarray(x[0]), self.fleet.aux)
        self.slots: List[Optional[_Slot]] = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first
        # sized for a full-capacity join storm plus monitor registrations
        self._cmd: "queue.Queue" = queue.Queue(maxsize=max(256, capacity * 4))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stat = EngineStat(tick_rate=cfg.ticks_per_second)
        self.tick = 0
        self._lock = threading.Lock()  # slots/occupancy views
        # monitor tap keys: every Monitor module in the template
        self._tap_keys = [
            str(mid.value)
            for mid, e in template.modules.items()
            if e.params.kind == "Monitor"
        ]
        # all device interaction rides a probed worker with per-job
        # timeouts (engine.py _DeviceWorker); a failed probe raises
        self.block_faults = {"lost": 0, "redispatched": 0, "dropped": 0}
        self._worker = _make_probed_worker()
        self._job_timeout = 30.0
        self._warm()

    # -- lifecycle -----------------------------------------------------------

    def _device_job(self, fn, timeout=None):
        out = self._worker.submit(fn, timeout or self._job_timeout)
        if out is _LOST:
            self.block_faults["lost"] += 1
            log.warning("fleet device op lost; replacing worker")
            self._worker = _make_probed_worker(first_budget=30.0)
        return out

    def _warm(self):
        """Compile + first dispatch (probed worker, boot-sized budget).
        The warm block runs with the reset mask all-True, which is also
        what the first served block will do — state starts at init."""

        def job():
            host_aux = self.fleet.host_aux(0)
            state, taps = self._step(
                self.fleet.aux, host_aux, self.fleet.state, self._reset_mask
            )
            return state, _fetch(taps)

        self._device_job(job, timeout=600.0)
        # mask stays all-True: the first REAL block re-inits every slot

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-engine"
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10.0)

    # -- session API (any thread) ---------------------------------------------

    def join(self, timeout: float = 10.0) -> Optional[_Slot]:
        done: "queue.Queue" = queue.Queue(maxsize=1)
        self._cmd.put(("join", done), timeout=timeout)
        return done.get(timeout=timeout)

    def leave(self, slot: _Slot):
        try:
            self._cmd.put(("leave", slot), timeout=5.0)
        except queue.Full:
            pass

    def update(self, slot: _Slot, msg: p.WorkspaceMessage):
        """Queue one client op; Sync (and the op's outcome) is echoed on
        slot.events."""
        self._cmd.put(("op", slot, msg), timeout=5.0)

    def add_monitor(self, slot: _Slot, sub: _MonitorSub):
        self._cmd.put(("monitor+", slot, sub), timeout=5.0)

    def remove_monitor(self, slot: _Slot, sub: _MonitorSub):
        try:
            self._cmd.put(("monitor-", slot, sub), timeout=5.0)
        except queue.Full:
            pass

    def add_events(self, slot: _Slot, sub: _MonitorSub):
        self._cmd.put(("events+", slot, sub), timeout=5.0)

    def remove_events(self, slot: _Slot, sub: _MonitorSub):
        try:
            self._cmd.put(("events-", slot, sub), timeout=5.0)
        except queue.Full:
            pass

    def status(self) -> dict:
        with self._lock:
            occupied = sum(1 for s in self.slots if s is not None)
        stat = self._stat
        mean = 0.0
        if getattr(self, "_run_t0", None) and self.tick:
            mean = self.tick / (time.monotonic() - self._run_t0)
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "tick": self.tick,
            "block_ticks": self.block.n_ticks,
            "achieved_tick_rate": round(mean, 2),
            "on_schedule_fraction": round(stat.realtime_fraction_total, 4),
            "max_late_ms": round(stat.total_max_late_s * 1e3, 2)
            if stat.total_max_late_s > -1e8
            else None,
        }

    # -- engine thread ---------------------------------------------------------

    def _run(self):
        start = time.monotonic()
        self._run_t0 = start
        tps = self.cfg.ticks_per_second
        n = self.block.n_ticks
        while not self._stop.is_set():
            this_tick = self.tick
            scheduled_end = start + (this_tick + n) / tps
            behind = time.monotonic() - scheduled_end
            if behind > 1.0:
                # re-anchor rather than burst (Engine._run discipline)
                start += behind
                scheduled_end += behind
            self._stat.record_tick(scheduled_end, lambda ts: self._block_once())
            # drain commands, then sleep to the absolute deadline
            while True:
                try:
                    timeout = scheduled_end - time.monotonic()
                    if timeout <= 0:
                        cmd = self._cmd.get_nowait()
                    else:
                        cmd = self._cmd.get(timeout=timeout)
                except queue.Empty:
                    break
                try:
                    self._process_cmd(cmd)
                except Exception:
                    log.exception("fleet command failed; loop continues")

    def _block_once(self):
        cfg = self.cfg
        t0 = self.tick * cfg.samples_per_tick
        S = self.block.n_samples(cfg)
        host_aux = self.fleet.host_aux(t0)
        pre_state = self.fleet.state  # retained for re-dispatch on loss
        mask = self._reset_mask.copy()  # resets consumed by THIS block

        def dispatch():
            import jax

            state, taps = self._step(self.fleet.aux, host_aux, pre_state,
                                     mask)
            # start the device->host transfer NOW; it overlaps the next
            # block's compute and is materialized one block later
            for leaf in jax.tree_util.tree_leaves(taps):
                start = getattr(leaf, "copy_to_host_async", None)
                if start is not None:
                    start()
            return state, taps

        out = self._device_job(dispatch)
        if out is _LOST:
            self.block_faults["redispatched"] += 1
            out = self._device_job(dispatch)  # re-dispatch: pre-state+mask
        if out is _LOST:
            self.block_faults["dropped"] += 1
            # drop this block (monitor clients lose one PCM packet; the
            # schedule re-anchors if we fell far behind)
            self.tick += self.block.n_ticks
            return
        self.fleet.state, taps = out
        self._reset_mask &= ~mask  # later joins' bits survive
        self._inflight.append((t0, taps))
        if len(self._inflight) <= 1:
            self.tick += self.block.n_ticks
            return  # pipeline fill: first block's taps arrive next round
        t0_prev, taps_prev = self._inflight.pop(0)
        fetched = self._device_job(lambda: _fetch(taps_prev))
        if fetched is _LOST:
            self.block_faults["dropped"] += 1
            self.tick += self.block.n_ticks
            return  # lost transfer: that block's monitor packets drop
        self._fan_out(t0_prev, fetched)
        self.tick += self.block.n_ticks

    def _fan_out(self, t0: int, taps):
        """One framed PCM packet per occupied slot per monitor."""
        S = self.block.n_samples(self.cfg)
        for slot in self.slots:
            if slot is None or not slot.monitors:
                continue
            if t0 < slot.joined_sample:
                # an in-flight block dispatched before this session joined
                # belongs to the slot's PREVIOUS occupant — never deliver it
                continue
            for key in self._tap_keys:
                tp = taps.get(key)
                if tp is None:
                    continue
                l, r = tp["audio"]
                pcm = np.empty((S, 2), dtype=np.int16)
                pcm[:, 0] = l[slot.index].reshape(-1)
                pcm[:, 1] = r[slot.index].reshape(-1)
                pkt = frame_packet(
                    {"t": "pcm", "t0": t0, "rate": self.cfg.sample_rate,
                     "channels": 2},
                    pcm.tobytes(),
                )
                for sub in list(slot.monitors):
                    sub.push_threadsafe(pkt)

    def _process_cmd(self, cmd):
        kind = cmd[0]
        if kind == "join":
            done = cmd[1]
            with self._lock:
                if not self._free:
                    done.put(None)
                    return
                index = self._free.pop()
                slot = _Slot(index, self.template.snapshot())
                slot.joined_sample = self.tick * self.cfg.samples_per_tick
                self.slots[index] = slot
            # pure host work: a fresh session starts as the template (its
            # aux row already is), with its DSP state re-initialized by the
            # next block's reset mask
            self._reset_mask[index] = True
            done.put(slot)
        elif kind == "leave":
            slot = cmd[1]
            with self._lock:
                if self.slots[slot.index] is slot:
                    self.slots[slot.index] = None
                    self._free.append(slot.index)
            slot.monitors.clear()
            # mute the vacated slot back to the template (host aux write)
            # and clear its state via the next block's reset mask
            import jax

            def put_row(stacked, leaf):
                stacked[slot.index] = leaf
                return stacked

            self.fleet.aux = jax.tree.map(put_row, self.fleet.aux,
                                          self._template_aux_row)
            self.fleet._instance_patches[slot.index] = self.fleet.patch
            self._reset_mask[slot.index] = True
        elif kind == "op":
            _, slot, msg = cmd
            self._apply_op(slot, msg)
        elif kind == "monitor+":
            _, slot, sub = cmd
            slot.monitors.append(sub)
        elif kind == "monitor-":
            _, slot, sub = cmd
            if sub in slot.monitors:
                slot.monitors.remove(sub)
        elif kind == "events+":
            _, slot, sub = cmd
            slot.event_subs.append(sub)
        elif kind == "events-":
            _, slot, sub = cmd
            if sub in slot.event_subs:
                slot.event_subs.remove(sub)

    def _apply_op(self, slot: _Slot, msg: p.WorkspaceMessage):
        """Param edits only; structural ops are rejected typed (the fleet
        tier's documented scope).  Sync is always echoed so the client's
        optimistic UI un-gates (frontend/src/session.rs:93-108); rejected
        ops additionally echo an error event."""
        op = msg.op
        err = None
        if isinstance(op, p.UpdateModuleParams):
            entry = slot.ws.modules.get(op.module_id)
            if entry is None:
                err = "no such module"
            else:
                before = entry.params
                slot.ws.update_params(op.module_id, op.params)
                try:
                    # host-memory aux write (no device ops; the next
                    # dispatch ships it)
                    self.fleet.update_instance_aux(slot.index, slot.ws)
                except ValueError as e:
                    # structural change (e.g. waveform): roll back
                    slot.ws.update_params(op.module_id, before)
                    err = str(e)
        elif isinstance(op, p.UpdateWindowGeometry):
            if op.module_id in slot.ws.geometry:
                slot.ws.geometry[op.module_id] = op.geometry
        else:
            err = (
                "structural edits need a dedicated engine; the fleet tier "
                "serves one shared graph structure"
            )
        self._post_event(slot, ("sync", msg.sequence))
        if err is not None:
            self._post_event(slot, ("error", msg.sequence, err))

    @staticmethod
    def _post_event(slot: _Slot, ev):
        _post(slot.events, ev)
        for sub in list(slot.event_subs):
            sub.push_threadsafe(ev)


def _post(q: "queue.Queue", item):
    try:
        q.put_nowait(item)
    except queue.Full:
        pass


def _fetch(tree):
    """Overlapped device->host fetch (engine.py _fetch_tree semantics)."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten(tree)
    for x in flat:
        start = getattr(x, "copy_to_host_async", None)
        if start is not None:
            start()
    return jax.tree_util.tree_unflatten(treedef, [np.asarray(x) for x in flat])


# ---------------------------------------------------------------------------
# websocket server
# ---------------------------------------------------------------------------


class FleetServeApp:
    """Asyncio server for a FleetEngine.

    Routes:
      * ``GET /fleet``   — websocket: join (Joined + WorkspaceState), then
        WorkspaceMessage ops in / Sync + framed i16 PCM monitor blocks out
      * ``GET /status``  — JSON occupancy + schedule health
    """

    def __init__(self, engine: FleetEngine):
        self.engine = engine
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self, bind: str = "127.0.0.1", port: int = 0) -> int:
        # backlog sized for a full-fleet connect storm
        self._server = await asyncio.start_server(
            self._handle, bind, port, backlog=4096
        )
        return self._server.sockets[0].getsockname()[1]

    async def shutdown(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            req = await read_request(reader)
            if req is None:
                return
            if req.path == "/status" and req.method == "GET":
                body = json.dumps(self.engine.status()).encode()
                writer.write(response(200, "OK", body, content_type="application/json"))
                await writer.drain()
            elif req.path.startswith("/fleet") and req.method == "GET":
                await self._handle_fleet_ws(req, reader, writer)
            else:
                writer.write(response(404, "Not Found", b""))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_fleet_ws(self, req: Request, reader, writer):
        key = req.header("sec-websocket-key")
        if req.header("upgrade", "").lower() != "websocket" or not key:
            writer.write(response(400, "Bad Request", b"websocket required"))
            await writer.drain()
            return
        # no permessage-deflate: the stream is mostly i16 PCM (poor ratio,
        # real CPU cost at fleet scale)
        writer.write(ws_mod.handshake_response(key))
        await writer.drain()
        sock = ws_mod.WebSocket(reader, writer)

        loop = asyncio.get_running_loop()
        slot = await loop.run_in_executor(None, self.engine.join, 30.0)
        if slot is None:
            await sock.send_text(json.dumps({"t": "Full"}))
            await sock.close()
            return
        sub = _MonitorSub(loop)
        esub = _MonitorSub(loop)
        self.engine.add_monitor(slot, sub)
        self.engine.add_events(slot, esub)
        state = _dump_state(slot.ws)
        await sock.send_text(
            json.dumps({"t": "Joined", "slot": slot.index,
                        "capacity": self.engine.capacity})
        )
        await sock.send_text(wire.server_message("WorkspaceState", state))

        stop = asyncio.Event()

        async def pump_monitor():
            while not stop.is_set():
                try:
                    pkt = await asyncio.wait_for(sub.q.get(), timeout=0.25)
                except asyncio.TimeoutError:
                    continue
                try:
                    await sock.send_binary(pkt)
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
            stop.set()

        async def pump_events():
            while not stop.is_set():
                try:
                    ev = await asyncio.wait_for(esub.q.get(), timeout=0.25)
                except asyncio.TimeoutError:
                    continue
                try:
                    if ev[0] == "sync":
                        await sock.send_text(
                            json.dumps({"t": "Sync", "sequence": ev[1]})
                        )
                    elif ev[0] == "error":
                        await sock.send_text(
                            json.dumps({"t": "Error", "sequence": ev[1],
                                        "message": ev[2]})
                        )
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
            stop.set()

        pumps = [
            asyncio.create_task(pump_monitor()),
            asyncio.create_task(pump_events()),
        ]
        try:
            while True:
                msg = await sock.recv()
                if msg is None:
                    break
                _, payload = msg
                try:
                    kind, body = wire.parse_envelope(payload)
                    wsmsg = (
                        wire.decode(body, p.WorkspaceMessage)
                        if kind == "Workspace"
                        else None
                    )
                except (ValueError, json.JSONDecodeError):
                    continue  # strict decode: hostile payloads are skipped
                if wsmsg is not None:
                    await loop.run_in_executor(
                        None, self.engine.update, slot, wsmsg
                    )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            stop.set()
            for t in pumps:
                t.cancel()
            self.engine.remove_monitor(slot, sub)
            self.engine.remove_events(slot, esub)
            self.engine.leave(slot)
            await sock.close()


def _queue_get(q: "queue.Queue", timeout: float):
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        return None


def _dump_state(ws: Workspace) -> p.WorkspaceState:
    state = p.WorkspaceState()
    for mid, entry in ws.modules.items():
        state.modules.append((mid, entry.params))
        state.inputs.append((mid, list(entry.inputs)))
        state.outputs.append((mid, list(entry.outputs)))
    for mid, geom in ws.geometry.items():
        state.geometry.append((mid, geom))
    for mid, ind in ws.indications.items():
        state.indications.append((mid, ind))
    for i, o in ws.connections.items():
        state.connections.append((i, o))
    return state
