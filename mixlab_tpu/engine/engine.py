"""Realtime host engine: tick loop, sessions, op-log, edits.

Rebuild of ``src/engine.rs`` around the compiled-graph execution model:

  * a dedicated thread runs a fixed-rate tick loop with absolute-scheduled
    deadlines (drift-free: deadline = start + (tick+1)/tps, engine.rs:175);
  * client ops arrive over a bounded command queue (depth 8; full -> Busy,
    engine.rs:74,105-112) and are processed between ticks;
  * every op is rebroadcast to all sessions as a ServerUpdate plus a
    Sync(OpClock) echo for optimistic-UI reconciliation
    (engine.rs:269-275,397); OpClock = (session_id, client_sequence) and is
    only ordered within a session (engine.rs:38-50);
  * each edit snapshots the workspace for persistence (the reference's
    watch-channel-on-borrow-drop, workspace.rs:176-182, becomes an explicit
    callback after each applied op).

Execution model per tick: host feeds (stream ingest PCM) are gathered,
the jitted block program runs on device, taps are routed to host pipelines
(monitor/plotter/output_device), then the host video pass runs video modules
in the same topo order.  Edits that keep the structural fingerprint only
swap the traced aux pytree (no recompile); structural edits rebuild the
program and carry DSP state per module (eq poles survive a gain edit,
matching eq_three.rs:53-56).

DSP-state checkpointing (``checkpoint``/``restore``) is an extension of
this build: the reference persists only declarative params (persist.rs:9-21);
here the explicit state pytree makes runtime state snapshottable too.
"""

from __future__ import annotations

import logging
import queue
from collections import deque
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


_LOST = object()


def _fetch_tree(tree):
    """Device->host fetch of every leaf with the transfers OVERLAPPED:
    start copy_to_host_async on all device leaves first, then
    materialize, so the transfers of all leaves overlap instead of each
    waiting for the previous one (channel-major stereo taps doubled the
    audio leaf count)."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten(tree)
    for x in flat:
        start = getattr(x, "copy_to_host_async", None)
        if start is not None:
            start()
    return jax.tree_util.tree_unflatten(treedef, [np.asarray(x) for x in flat])


class _DeviceWorker(threading.Thread):
    """Runs device interactions (dispatch, device->host transfer) with a
    per-job timeout.

    A device call that never returns (a dispatched block's transfer, or
    the dispatch itself) would wedge the engine thread forever, and a
    blocking native call cannot be cancelled, so jobs run on this
    dedicated thread; a caller that times out marks the worker unusable
    and abandons it (the thread stays blocked in the lost call — daemonic,
    holds no locks), and the engine spawns a fresh worker for the next
    block.  Every such loss is counted (``Engine.block_faults``)."""

    def __init__(self):
        super().__init__(daemon=True, name="device-worker")
        self._jobs: "queue.Queue" = queue.Queue()
        self.usable = True

    def submit(self, fn, timeout: float):
        """-> fn() result, or the _LOST sentinel on timeout."""
        done = threading.Event()
        box: dict = {}
        self._jobs.put((fn, done, box))
        if not done.wait(timeout):
            self.usable = False  # stuck in a lost native call
            return _LOST
        if "e" in box:
            raise box["e"]
        return box["r"]

    def run(self):
        while True:
            fn, done, box = self._jobs.get()
            try:
                box["r"] = fn()
            except BaseException as e:
                box["e"] = e
            finally:
                done.set()


class DeviceUnavailable(RuntimeError):
    """The device did not answer a probe: no engine runs without it."""


def _make_probed_worker(attempts: int = 5,
                        first_budget: float = 300.0) -> _DeviceWorker:
    """Spawn a _DeviceWorker and make it pass an initiation probe: a
    worker is only handed real jobs once a tiny dispatch+fetch has
    completed on it.  Raises :class:`DeviceUnavailable` when no worker
    passes."""
    import jax.numpy as jnp

    def _probe_op():
        return float(jnp.zeros((8,), dtype=jnp.float32).sum() + 1.0)

    # every device touch happens on a worker with a timeout — a wedged
    # backend must never hang the constructing (main/server) thread.  The
    # first probe's budget covers backend init + the probe-op compile;
    # runtime re-probes pass a short budget — the backend is already up.
    for attempt in range(attempts):
        worker = _DeviceWorker()
        worker.start()
        timeout = first_budget if attempt == 0 else 5.0
        if worker.submit(_probe_op, timeout) is not _LOST:
            return worker
        log.warning("device worker failed initiation probe; replacing")
    raise DeviceUnavailable(
        f"{attempts} device workers failed their initiation probe")

from mixlab_tpu import protocol as p
from mixlab_tpu.dsp.registry import get_def
from mixlab_tpu.engine.compiler import CompiledPatch, compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.feeds import StreamInputFeed
from mixlab_tpu.engine.graph import ConnectError, Workspace
from mixlab_tpu.engine.timing import EngineStat, temporal_warning
from mixlab_tpu.io_host import source as source_registry
from mixlab_tpu.protocol import (
    Indication,
    InputId,
    LineType,
    ModuleId,
    OutputId,
    WindowGeometry,
)
from mixlab_tpu.video.engine import VideoMixerState, video_mixer_tick


# ---------------------------------------------------------------------------
# events / sessions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpClock:
    session_id: int
    sequence: int


@dataclass(frozen=True)
class SyncEvent:
    clock: OpClock


@dataclass(frozen=True)
class UpdateEvent:
    update: object  # ServerUpdate


class EngineError(Exception):
    pass


class Busy(EngineError):
    pass


class Stopped(EngineError):
    pass


class _Broadcast:
    """tokio::broadcast(64) analogue; lagging subscribers are dropped
    (matching the server's forced disconnect on lag, server.rs:251-254)."""

    def __init__(self, depth: int = 64):
        self._subs: List[queue.Queue] = []
        self._lock = threading.Lock()
        self._depth = depth

    def subscribe(self) -> queue.Queue:
        q = queue.Queue(maxsize=self._depth)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue):
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def send(self, ev):
        with self._lock:
            dead = []
            for q in self._subs:
                try:
                    q.put_nowait(ev)
                except queue.Full:
                    dead.append(q)
            for q in dead:
                self._subs.remove(q)
                try:
                    q.put_nowait(None)  # lag sentinel -> session closes
                except queue.Full:
                    pass


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class _MonitorPipe:
    """Bounded tick queue to a monitor/stream codec thread; drop-on-full
    (monitor.rs:164-176)."""

    q: queue.Queue = field(default_factory=lambda: queue.Queue(maxsize=2))
    dropped: int = 0

    def push(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except queue.Full:
            self.dropped += 1
            return False


class Engine:
    def __init__(
        self,
        workspace: Optional[Workspace] = None,
        cfg: EngineConfig = EngineConfig(),
        persist_cb: Optional[Callable[[dict], None]] = None,
        block_ticks: int = 1,
        media_opener: Optional[Callable] = None,
        pipeline_depth: int = 0,
        patch_compiler: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.ws = workspace or Workspace()
        # pluggable graph lowering: (ws, cfg, block) -> CompiledPatch-shaped
        # object.  Default = single-device compile_patch; parallel/stems.py
        # StemsPatch.compiler(mesh, n) lowers the same workspace to a
        # shard_map program over a device mesh, so the WHOLE live engine
        # (edits, async compile-and-swap, taps, monitor) runs multi-chip
        # without further changes (SURVEY §7.8).
        self._patch_compiler = patch_compiler or compile_patch
        self.persist_cb = persist_cb
        self.media_opener = media_opener
        self.block = BlockSpec(block_ticks)
        # issue-ahead depth for the realtime loop (0 = fetch synchronously)
        self.pipeline_depth = pipeline_depth
        self._inflight: deque = deque()

        self._cmd: queue.Queue = queue.Queue(maxsize=8)
        self._log = _Broadcast(64)
        self._perf_lock = threading.Lock()
        self._perf: Optional[p.PerformanceInfo] = None
        self._session_seq = 0
        self._stat = EngineStat(cfg.ticks_per_second)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # host-module state
        self._video_mixers: Dict[ModuleId, VideoMixerState] = {}
        self._stream_feeds: Dict[ModuleId, StreamInputFeed] = {}
        self._monitor_pipes: Dict[ModuleId, _MonitorPipe] = {}
        self._monitor_pipelines: Dict[ModuleId, object] = {}
        self._stream_outputs: Dict[ModuleId, object] = {}
        self._media_feeds: Dict[ModuleId, object] = {}
        self._media_players: Dict[ModuleId, object] = {}
        self._plotter_counts: Dict[ModuleId, int] = {}
        self._clip_times: Dict[ModuleId, float] = {}
        self._lag_times: Dict[ModuleId, float] = {}
        self._audio_streams: Dict[ModuleId, object] = {}

        self.tick = 0
        # async compile machinery: structural edits compile on a worker
        # thread while the engine keeps ticking the OLD program; the new
        # program is swapped in (with DSP state carried over) once its first
        # run is warm.  This keeps the 60 Hz cadence through edits — the
        # newly added module simply becomes audible a moment later.  Offline
        # and direct-drive (no engine thread) modes compile synchronously.
        self._pending_patch = None  # (patch, compile generation)
        self._pending_lock = threading.Lock()
        self._compile_gen = 0
        # Serializes every device API call (dispatch, fetch, warm run)
        # across ALL threads — engine, compile worker, codec threads,
        # media decoders (see utils/devlock.py for the failure class).
        from mixlab_tpu.utils.devlock import DEVICE_LOCK

        self._device_lock = DEVICE_LOCK
        # One compile worker, latest-wins: an edit storm must not fan out
        # into concurrent compiles.
        self._compile_q: queue.Queue = queue.Queue()
        self._compile_worker: Optional[threading.Thread] = None
        # Device blocks that were lost (timed out), re-dispatched after a
        # loss, or dropped (no output after every retry): a healthy device
        # keeps all three at zero.  /_metrics exports them.
        self.block_faults = {"lost": 0, "redispatched": 0, "dropped": 0}
        # The device worker is created EAGERLY, at boot, so a device that
        # does not answer stops the engine here (DeviceUnavailable).
        self._devworker = _make_probed_worker()
        self._rebuild(full=True)

    # -- compiled program management --------------------------------------

    def _rebuild(self, full: bool):
        patch = self._patch_compiler(self.ws, self.cfg, self.block)
        old_patch = getattr(self, "_patch", None)
        if (
            not full
            and old_patch is not None
            and patch.structural_fingerprint == old_patch.structural_fingerprint
        ):
            # param-only change: swap aux, keep program + state.  Any
            # in-flight structural compile is now stale — an edit pair can
            # net out to the RUNNING structure (create module -> delete it
            # again) while a pending patch still references the deleted
            # module; adopting it would crash prepare_aux against the live
            # ws (soak-caught, round 4).  Superseding here keeps the
            # invariant: a staged patch always matches the newest ws.
            with self._pending_lock:
                self._compile_gen += 1
                self._pending_patch = None
            self._aux = old_patch.prepare_aux(self.ws)
            return
        if old_patch is not None and self._thread is not None:
            # realtime: warm the new program off-thread, swap when ready.
            # Snapshot the warm inputs HERE, on the engine thread, against
            # the workspace this patch was compiled from — the worker must
            # never read the live ws (a later edit could delete a module
            # mid-warm and crash the job with a spurious KeyError).
            # Deliberately LOCK-FREE: the engine thread's tiny jnp scalar
            # creations are the long-proven param-edit precedent (line
            # above in the param-only branch), and taking DEVICE_LOCK here
            # unbounded would stall ticking behind a worker's minutes-long
            # warm (the tick path survives that case via bounded acquires).
            warm_args = (patch.prepare_aux(self.ws),
                         patch.init_state(self.ws), patch.host_aux(0))
            with self._pending_lock:
                self._compile_gen += 1
                gen = self._compile_gen
                self._pending_patch = None  # superseded by this edit
            self._compile_q.put((patch, gen, warm_args))
            if self._compile_worker is None or not self._compile_worker.is_alive():
                self._compile_worker = threading.Thread(
                    target=self._compile_loop, daemon=True, name="compile"
                )
                self._compile_worker.start()
        else:
            self._adopt_patch(patch)
        self._sync_host_modules()

    def _compile_loop(self):
        while not self._stop.is_set():
            try:
                job = self._compile_q.get(timeout=1.0)
            except queue.Empty:
                continue
            # latest-wins: under an edit storm only the newest graph matters
            while True:
                try:
                    job = self._compile_q.get_nowait()
                except queue.Empty:
                    break
            patch, gen, warm_args = job
            with self._pending_lock:
                if gen != self._compile_gen:
                    continue  # superseded while queued
            # compile-class work belongs on the jax home thread when a
            # DeviceHost is serving (the live server); inline otherwise.
            # Bounded: a wedged device host must not absorb the compile
            # worker forever (a late completion still stages; gen-guarded)
            from mixlab_tpu.utils.devhost import device_call

            try:
                ok = device_call(
                    lambda: self._warm_and_stage(patch, gen, warm_args),
                    timeout=300.0)
            except TimeoutError:
                log.error("compile job stalled >300 s; device host "
                          "unresponsive — edit not adopted")
                ok = False
            if not ok:
                # a lost warm run: RETRY the swap until it lands or a newer edit supersedes
                # it — an edit must never silently stay un-adopted forever
                with self._pending_lock:
                    superseded = gen != self._compile_gen
                if not superseded and not self._stop.is_set():
                    log.warning("swap for gen %d will retry in 15 s", gen)
                    self._stop.wait(15.0)
                    self._compile_q.put((patch, gen, warm_args))

    def _warm_and_stage(self, patch: CompiledPatch, gen: int, warm_args):
        try:
            import jax

            # warm inputs were snapshotted on the engine thread at edit
            # time (consistent with the compiled graph)
            aux, state, host_aux = warm_args
            # compile + first execution under the lock
            with self._device_lock:
                out = patch.run(aux, host_aux, state)
            # a lost warm transfer must not hang the compile worker (and,
            # in the live server, the whole DeviceHost) — bounded fetch,
            # retry, and abandon the swap if the device keeps eating it.
            # The warm timeout is generous: this fetch also absorbs the
            # first-execution latency of the freshly compiled program.
            for attempt in range(1 + self.DISPATCH_RETRIES):
                if self._fetch_with_timeout(out, 30.0) is not None:
                    break
                self.block_faults["lost"] += 1
                log.error("warm transfer lost (attempt %d); retrying",
                          attempt + 1)
                with self._device_lock:
                    out = patch.run(aux, host_aux, state)
            else:
                self.block_faults["dropped"] += 1
                log.error("warm run lost repeatedly; abandoning this swap")
                return False
            patch._warmed = True
        except Exception:
            log.exception("async compile failed")
            return False
        with self._pending_lock:
            if gen == self._compile_gen:
                self._pending_patch = (patch, gen)  # picked up by engine thread
        return True

    def _maybe_swap_patch(self):
        with self._pending_lock:
            staged = self._pending_patch
            self._pending_patch = None
            if staged is None:
                return
            patch, gen = staged
            # A patch compiled against an older workspace snapshot must never
            # be adopted: under an edit storm, a newer structural edit can
            # land between staging and this swap; its own compile is in
            # flight and will supersede this one.  (engine.rs keeps this
            # trivially true by doing everything on one thread.)
            if gen != self._compile_gen:
                return
        # defense in depth: the gen protocol above should guarantee the
        # staged patch matches the live workspace, but adopting a stale
        # one would KILL the engine thread (prepare_aux KeyError) — so
        # verify every compiled module still exists before committing
        if any(mid not in self.ws.modules for mid in patch.order):
            log.error("staged patch references deleted modules; discarded "
                      "(gen protocol breach — please report)")
            return
        self._adopt_patch(patch)

    def _adopt_patch(self, patch: CompiledPatch):
        old_state = getattr(self, "_state", None)
        self._patch = patch
        self._aux = patch.prepare_aux(self.ws)
        new_state = patch.init_state(self.ws)
        if old_state is not None:
            # carry DSP state for surviving modules of unchanged kind
            for k, st in new_state.items():
                if k in old_state:
                    mid = ModuleId(int(k))
                    entry = self.ws.modules.get(mid)
                    if entry is not None:
                        d = get_def(entry.params.kind)
                        carried = d.carry_state(
                            old_state[k], entry.params.params, self.cfg
                        )
                        if carried is not None and _same_structure(carried, st):
                            new_state[k] = carried
        self._state = new_state

    def _sync_host_modules(self):
        live = set(self.ws.modules)
        for mid, entry in self.ws.modules.items():
            kind = entry.params.kind
            if kind == "VideoMixer" and mid not in self._video_mixers:
                self._video_mixers[mid] = VideoMixerState()
            if kind == "StreamInput" and mid not in self._stream_feeds:
                feed = StreamInputFeed(self.cfg)
                self._stream_feeds[mid] = feed
                self._listen_mountpoint(mid, entry.params.params)
            if kind in ("Monitor", "StreamOutput") and mid not in self._monitor_pipes:
                pipe = _MonitorPipe()
                self._monitor_pipes[mid] = pipe
                if kind == "Monitor":
                    # spawn the codec thread + socket registration and expose
                    # the socket id as the module indication (monitor.rs:24-66)
                    from mixlab_tpu.server.monitor import MonitorPipeline

                    pipeline = MonitorPipeline(pipe, self.cfg)
                    pipeline.start()
                    self._monitor_pipelines[mid] = pipeline
                    self.ws.indications[mid] = Indication(
                        "Monitor", p.MonitorIndication(pipeline.socket_id)
                    )
                else:  # StreamOutput: connection state machine controller
                    from mixlab_tpu.server.stream_output import (
                        StreamOutputController,
                    )

                    def _indicate(ind, mid=mid):
                        self._post_indication(mid, ind)

                    ctl = StreamOutputController(pipe, self.cfg, _indicate)
                    ctl.params = entry.params.params
                    self._stream_outputs[mid] = ctl
                    self.ws.indications[mid] = Indication(
                        "StreamOutput", ctl.indication()
                    )
            if kind == "MediaSource" and mid not in self._media_feeds:
                from mixlab_tpu.engine.feeds import MediaSourceFeed

                self._media_feeds[mid] = MediaSourceFeed(self.cfg)
                self._start_media_player(mid, entry.params.params)
            if kind == "OutputDevice" and mid not in self._audio_streams:
                self._open_audio_device(mid, entry.params.params)
            if kind == "Plotter" and mid not in self._plotter_counts:
                self._plotter_counts[mid] = 0
        for d_ in (
            self._video_mixers,
            self._stream_feeds,
            self._monitor_pipes,
            self._monitor_pipelines,
            self._stream_outputs,
            self._media_feeds,
            self._media_players,
            self._plotter_counts,
            self._clip_times,
            self._lag_times,
            self._audio_streams,
        ):
            for mid in [m for m in d_ if m not in live]:
                if d_ is self._stream_feeds:
                    d_[mid].set_recv(None)
                if (
                    d_ is self._monitor_pipelines
                    or d_ is self._stream_outputs
                    or d_ is self._media_players
                ):
                    d_[mid].stop()
                if d_ is self._audio_streams and d_[mid] is not None:
                    d_[mid].close()
                del d_[mid]

    def _open_audio_device(self, mid: ModuleId, params: p.OutputDeviceParams):
        from mixlab_tpu.io_host.audio_out import get_backend

        backend = get_backend()
        old = self._audio_streams.pop(mid, None)
        if old is not None:
            old.close()
        stream = None
        if params.device is not None:
            stream = backend.open(params.device, self.cfg.sample_rate)
        self._audio_streams[mid] = stream
        # device enumeration indication (output_device.rs:49-70)
        self.ws.indications[mid] = Indication(
            "OutputDevice",
            p.OutputDeviceIndication(
                default_device=backend.default_device(),
                devices=tuple(backend.devices()),
            ),
        )

    def _start_media_player(self, mid: ModuleId, params: p.MediaSourceParams):
        old = self._media_players.pop(mid, None)
        if old is not None:
            old.stop()
        if params.media_id is None or self.media_opener is None:
            return
        stream = self.media_opener(params.media_id)
        if stream is None:
            return
        from mixlab_tpu.engine.media_player import MediaPlayer

        player = MediaPlayer(stream, self._media_feeds[mid], self.cfg)
        player.start()
        self._media_players[mid] = player

    def _listen_mountpoint(self, mid: ModuleId, params: p.StreamInputParams):
        feed = self._stream_feeds[mid]
        recv = None
        if params.mountpoint and params.protocol is not None:
            reg = (
                source_registry.RTMP_MOUNTPOINTS
                if params.protocol == p.StreamProtocol.RTMP
                else source_registry.ICECAST_MOUNTPOINTS
            )
            try:
                recv = reg.listen(params.mountpoint)
            except source_registry.ListenError:
                recv = None  # TODO indication (stream_input.rs:63 TODO too)
        feed.set_recv(recv)

    # -- session API (thread-safe) ----------------------------------------

    def connect_session(self) -> Tuple[int, p.WorkspaceState, queue.Queue]:
        done = queue.Queue(maxsize=1)
        self._send_cmd(("connect", done))
        return done.get(timeout=5.0)

    def update(self, session_id: int, msg: p.WorkspaceMessage):
        self._send_cmd(("workspace", session_id, msg))

    def _send_cmd(self, cmd):
        if self._stop.is_set():
            raise Stopped()
        try:
            self._cmd.put_nowait(cmd)
        except queue.Full:
            raise Busy()
        if self._thread is None:
            # direct-drive mode (no engine thread running: offline render,
            # tests): process synchronously
            while True:
                try:
                    pending = self._cmd.get_nowait()
                except queue.Empty:
                    break
                self._process_cmd(pending)

    def session_count(self) -> int:
        """Connected live sessions (op-log subscribers); fleet placement
        weighs this ahead of raw workspace count."""
        return self._log.subscriber_count()

    def performance_info(self) -> Optional[p.PerformanceInfo]:
        with self._perf_lock:
            return self._perf

    def monitor_pipe(self, mid: ModuleId) -> Optional[_MonitorPipe]:
        return self._monitor_pipes.get(mid)

    # -- state checkpoint (extension) -------------------------------------

    def checkpoint(self) -> dict:
        import jax

        flat, treedef = jax.tree.flatten(self._state)

        def _fetch():
            with self._device_lock:
                return _fetch_tree(flat)

        if not flat:
            dsp = []  # empty graph: nothing on device to fetch
        else:
            # via the replaceable timed worker: a lost transfer yields an
            # empty (restore-incompatible) checkpoint, not a wedged engine
            dsp = self._device_job(_fetch, self.DISPATCH_TIMEOUT * 2)
            if dsp is _LOST:
                log.error("checkpoint state fetch lost; returning empty state")
                dsp = []
        return {
            "workspace": self.ws.to_persist(),
            "tick": self.tick,
            "dsp_state": dsp,
        }

    def restore_dsp_state(self, ckpt: dict) -> bool:
        import jax

        flat, treedef = jax.tree.flatten(self._state)
        if len(flat) == len(ckpt["dsp_state"]):
            self._state = jax.tree.unflatten(treedef, ckpt["dsp_state"])
            self.tick = ckpt.get("tick", 0)
            return True
        return False

    def checkpoint_sync(self, timeout: float = 30.0) -> dict:
        """Checkpoint taken ON the engine thread via the command queue
        (self._state is engine-thread-owned) — used for live migration
        (server/fleet.py)."""
        done: "queue.Queue" = queue.Queue(maxsize=1)
        self._send_cmd(("checkpoint", done))
        return done.get(timeout=timeout)

    def restore_sync(self, ckpt: dict, timeout: float = 10.0) -> bool:
        done: "queue.Queue" = queue.Queue(maxsize=1)
        self._send_cmd(("restore", ckpt, done))
        return bool(done.get(timeout=timeout))

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine")
        self._thread.start()

    def stop(self):
        self._stop.set()
        wedged = False
        if self._thread:
            self._thread.join(timeout=5.0)
            wedged = self._thread.is_alive()
        if wedged:
            # the engine thread is stuck in a device dispatch: fetching
            # in-flight results would block
            # shutdown indefinitely — abandon them so persistence still
            # flushes and the process can exit
            self._inflight.clear()
        else:
            self.flush_inflight()
        # tear down host-side workers (codec threads, RTMP publishers,
        # decoders, audio sinks) so shutdown is clean, not daemon-leaky
        for pipeline in self._monitor_pipelines.values():
            pipeline.stop()
        for ctl in self._stream_outputs.values():
            ctl.stop()
        for player in self._media_players.values():
            player.stop()
        # join decode threads so a subsequent ProjectBase.close() cannot race
        # an in-flight blob read (the reference serializes this by handle
        # ownership, src/project.rs:61-66)
        for player in self._media_players.values():
            if player.is_alive():
                player.join(timeout=2.0)
        # join the codec threads and the compile worker too: a daemon thread
        # still inside a jaxlib call when the interpreter exits aborts the
        # process ("terminate called ...")
        for thread in [*self._monitor_pipelines.values(), self._compile_worker]:
            if thread is not None and thread.is_alive():
                thread.join(timeout=10.0)
        for feed in self._stream_feeds.values():
            feed.set_recv(None)
        for stream in self._audio_streams.values():
            if stream is not None:
                stream.close()

    def _run(self):
        start = time.monotonic()
        tps = self.cfg.ticks_per_second
        n = self.block.n_ticks
        while not self._stop.is_set():
            this_tick = self.tick
            scheduled_end = start + (this_tick + n) / tps
            behind = time.monotonic() - scheduled_end
            if behind > 1.0:
                # More than a second behind the absolute schedule (a long
                # edit compile stalled dispatch, or the backend hiccuped):
                # re-anchor instead of bursting to catch up — a live DAW
                # wants a dropped second, not a rushed one.  Deviation from
                # the reference (engine.rs:175 keeps the original anchor),
                # which can never fall this far behind.
                start += behind
                scheduled_end += behind
            self._stat.record_tick(scheduled_end, lambda ts: self.tick_once(ts))
            if this_tick % (tps // 2) < n:
                with self._perf_lock:
                    self._perf = self._stat.report()
            # process commands, then wait for the deadline processing more
            while True:
                try:
                    timeout = scheduled_end - time.monotonic()
                    if timeout <= 0:
                        try:
                            cmd = self._cmd.get_nowait()
                        except queue.Empty:
                            break
                    else:
                        cmd = self._cmd.get(timeout=timeout)
                except queue.Empty:
                    break
                try:
                    self._process_cmd(cmd)
                except Exception:
                    # last-ditch: a command must never kill the tick loop
                    # (client_update has its own transactional guard; this
                    # covers connect/indicate/checkpoint/restore surprises)
                    log.exception("engine command %r failed; engine "
                                  "continues", cmd[0])

    # -- command processing -------------------------------------------------

    def _process_cmd(self, cmd):
        if cmd[0] == "connect":
            self._session_seq += 1
            sid = self._session_seq
            state = self._dump_state()
            q = self._log.subscribe()
            cmd[1].put((sid, state, q))
        elif cmd[0] == "workspace":
            _, session_id, msg = cmd
            self.client_update(session_id, msg)
        elif cmd[0] == "indicate":
            _, mid, ind = cmd
            if mid in self.ws.modules:
                self.ws.indications[mid] = ind
                self._log_op(p.SUUpdateModuleIndication(mid, ind))
        elif cmd[0] == "checkpoint":
            # state snapshot on the engine thread (it owns self._state)
            cmd[1].put(self.checkpoint())
        elif cmd[0] == "restore":
            cmd[2].put(self.restore_dsp_state(cmd[1]))

    def _post_indication(self, mid: ModuleId, ind: Indication):
        """Apply an indication produced by a host-side worker thread.

        The engine thread owns ``ws`` (the reference keeps every workspace
        mutation on its engine thread — src/engine/workspace.rs:148-170), so
        off-thread producers (e.g. StreamOutputController's connection state
        machine) enqueue the indication as a command instead of mutating
        directly.  Dropped when the command queue is full: indications are
        periodic status refreshes, not ops."""
        if self._thread is not None and threading.current_thread() is not self._thread:
            try:
                self._cmd.put_nowait(("indicate", mid, ind))
            except queue.Full:
                pass
            return
        if mid in self.ws.modules:
            self.ws.indications[mid] = ind
            self._log_op(p.SUUpdateModuleIndication(mid, ind))

    def _dump_state(self) -> p.WorkspaceState:
        state = p.WorkspaceState()
        for mid, entry in self.ws.modules.items():
            state.modules.append((mid, entry.params))
            state.inputs.append((mid, list(entry.inputs)))
            state.outputs.append((mid, list(entry.outputs)))
        for mid, geom in self.ws.geometry.items():
            state.geometry.append((mid, geom))
        for mid, ind in self.ws.indications.items():
            state.indications.append((mid, ind))
        for i, o in self.ws.connections.items():
            state.connections.append((i, o))
        return state

    def _log_op(self, update):
        self._log.send(UpdateEvent(update))

    def _persist(self):
        if self.persist_cb:
            self.persist_cb(self.ws.to_persist())

    def client_update(self, session_id: int, msg: p.WorkspaceMessage):
        """Apply one client op (engine.rs:277-398 semantics).

        Transactional: the engine thread must survive ANY op.  Strict wire
        decode (wire.WireDecodeError) keeps type-confused values out, but a
        semantic failure while applying (graph lowering, module prepare)
        would otherwise kill the tick loop for every session — the
        reference's equivalent would be a panic on its engine thread.  On
        failure: roll the workspace back to the pre-op snapshot, rebuild
        from the known-good state, and still emit Sync so the owning
        client's optimistic UI un-gates (frontend/src/session.rs:93-108).
        """
        snap = self.ws.snapshot()
        try:
            self._apply_client_op(msg)
        except Exception:
            log.exception("client op failed; rolling back workspace")
            self.ws.restore(snap)
            try:
                self._rebuild(full=True)
            except Exception:
                log.exception("rollback rebuild failed; engine continues "
                              "with the previous compiled patch")
        finally:
            self._log.send(SyncEvent(OpClock(session_id, msg.sequence)))

    def _apply_client_op(self, msg: p.WorkspaceMessage):
        op = msg.op
        if isinstance(op, p.CreateModule):
            mid = self.ws.create_module(op.params, op.geometry)
            entry = self.ws.modules[mid]
            self._rebuild(full=False)
            self._log_op(
                p.SUCreateModule(
                    id=mid,
                    params=op.params,
                    geometry=op.geometry,
                    indication=self.ws.indications[mid],
                    inputs=tuple(entry.inputs),
                    outputs=tuple(entry.outputs),
                )
            )
            self._persist()
        elif isinstance(op, p.UpdateModuleParams):
            entry = self.ws.modules.get(op.module_id)
            if entry is not None:
                # modules may REJECT an update (stream_output.rs:62-80: stale
                # seq, or param changes on a live output); the echoed params
                # are the module's actual post-update params, mirroring the
                # reference's `module.params()` echo (engine.rs:301-309)
                accepted = True
                if op.params.kind == "StreamOutput":
                    ctl = self._stream_outputs.get(op.module_id)
                    if ctl is not None:
                        ctl.update(op.params.params)
                        accepted = ctl.params is op.params.params
                if accepted:
                    old_params = entry.params
                    self.ws.update_params(op.module_id, op.params)
                    self._on_params_updated(op.module_id, old_params, op.params)
                    self._rebuild(full=False)
                self._log_op(
                    p.SUUpdateModuleParams(
                        op.module_id, self.ws.modules[op.module_id].params
                    )
                )
                self._persist()
        elif isinstance(op, p.UpdateWindowGeometry):
            if op.module_id in self.ws.geometry:
                self.ws.geometry[op.module_id] = op.geometry
                self._log_op(p.SUUpdateWindowGeometry(op.module_id, op.geometry))
                self._persist()
        elif isinstance(op, p.DeleteModule):
            if op.module_id in self.ws.modules:
                deleted = self.ws.delete_module(op.module_id)
                # _rebuild BEFORE broadcasting: if lowering throws, the
                # workspace rolls back server-side (client_update) — clients
                # that had already applied the SU* ops would be desynced from
                # the restored state until reconnect (the CreateModule branch
                # always ordered it this way)
                self._rebuild(full=False)
                for input_id in deleted:
                    self._log_op(p.SUDeleteConnection(input_id))
                self._log_op(p.SUDeleteModule(op.module_id))
                self._stat.remove_module(op.module_id)
                self._persist()
        elif isinstance(op, p.CreateConnection):
            try:
                prev = self.ws.connect(op.input_id, op.output_id)
            except ConnectError:
                prev = "rejected"
            if prev != "rejected":
                self._rebuild(full=False)
                if prev is not None:
                    self._log_op(p.SUDeleteConnection(op.input_id))
                self._log_op(p.SUCreateConnection(op.input_id, op.output_id))
                self._persist()
        elif isinstance(op, p.DeleteConnection):
            if self.ws.disconnect(op.input_id) is not None:
                self._rebuild(full=False)
                self._log_op(p.SUDeleteConnection(op.input_id))
                self._persist()

    def _on_params_updated(self, mid: ModuleId, old_params, new_params):
        kind = new_params.kind
        if kind == "StreamInput":
            oldp, newp = old_params.params, new_params.params
            if oldp.mountpoint != newp.mountpoint or oldp.protocol != newp.protocol:
                self._listen_mountpoint(mid, newp)
        elif kind == "MediaSource":
            if old_params.params.media_id != new_params.params.media_id:
                self._start_media_player(mid, new_params.params)
        elif kind == "OutputDevice":
            if old_params.params.device != new_params.params.device:
                self._open_audio_device(mid, new_params.params)

    # -- tick execution -----------------------------------------------------

    def tick_once(self, tick_stat=None) -> Dict[ModuleId, Indication]:
        """Run one block of ticks; returns indication changes."""
        cfg = self.cfg
        self._maybe_swap_patch()
        t0 = self.tick * cfg.samples_per_tick
        S = self.block.n_samples(cfg)

        # 1. host feeds
        running = {str(m.value) for m in self._patch.order}
        ext = {}
        stream_videos: Dict[ModuleId, object] = {}
        for mid, feed in self._stream_feeds.items():
            if str(mid.value) not in running:
                continue  # module added; its program is still compiling
            pcm, video = feed.fill_tick(t0, S)
            # feeds fill interleaved [S,2] (sample-exact splitting); the
            # device program wants channel-major [2,S] — one host memcpy
            ext[str(mid.value)] = {"pcm": np.ascontiguousarray(pcm.T)}
            stream_videos[mid] = video
        for mid, feed in self._media_feeds.items():
            if str(mid.value) in running:
                ext[str(mid.value)] = {
                    "pcm": np.ascontiguousarray(feed.fill_tick(S).T)
                }
                stream_videos[mid] = feed.take_video(S)

        # 2. device program (dispatch serialized vs the compile worker's
        # warm run — see _device_lock).  An empty patch is skipped outright:
        # a zero-input/zero-output executable has nothing to compute.
        if self._patch.order:
            host_aux = self._patch.host_aux(t0, ext)
            if self.pipeline_depth > 0:
                # issue-ahead mode must not wait for readiness here (the
                # whole point is overlapping fetch N with compute N+1);
                # it is used by offline/bench drivers on the home thread
                from mixlab_tpu.utils.devhost import device_call

                def _dispatch():
                    with self._device_lock:
                        return self._patch.run(
                            self._aux, host_aux, self._state
                        )

                self._state, taps = device_call(_dispatch)
            else:
                self._state, taps = self._run_block_resilient(host_aux)
        else:
            taps = {}

        # 3. host video pass (same topo order)
        video_buffers: Dict[OutputId, object] = {}
        for mid in self._patch.order:
            entry = self.ws.modules.get(mid)
            if entry is None:
                continue
            kind = entry.params.kind
            if kind in ("StreamInput", "MediaSource"):
                video_buffers[OutputId(mid, 0)] = stream_videos.get(mid)
            elif kind == "VideoMixer":
                vins = [
                    self._video_input(mid, i, video_buffers)
                    for i in range(len(entry.inputs))
                ]
                outs = video_mixer_tick(
                    self._video_mixers[mid],
                    entry.params.params,
                    vins,
                    t0,
                    cfg,
                )
                for i, frame in enumerate(outs):
                    video_buffers[OutputId(mid, i)] = frame

        # 4. route taps — immediately, or deferred one block when pipelined:
        # the device->host fetch of block N then overlaps block N+1's
        # device compute (issue-ahead dispatch)
        item = (t0, S, taps, video_buffers)
        if self.pipeline_depth > 0:
            self._inflight.append(item)
            if len(self._inflight) > self.pipeline_depth:
                indications = self._route_taps(*self._inflight.popleft())
            else:
                indications = {}
        else:
            indications = self._route_taps(*item)
        self.tick += self.block.n_ticks
        return indications

    # How long a block's device->host tap transfer may take before it is
    # declared lost.  A fetch that never returns would wedge the engine
    # forever (no cancellation API), so fetches run on a replaceable
    # worker thread with a timeout, and a lost block is re-dispatched
    # from the retained pre-block state (and counted in block_faults).
    DISPATCH_TIMEOUT = 3.0
    DISPATCH_RETRIES = 2

    def _device_job(self, fn, timeout: float):
        """Run a device interaction on the replaceable worker; _LOST on
        timeout (the blocked worker is abandoned and replaced).

        Replacement is THROTTLED to one probed replacement per 10 s; in
        between, jobs go to the existing worker and time out.  A
        replacement that fails its probe raises DeviceUnavailable."""
        worker = getattr(self, "_devworker", None)
        if worker is None or not worker.usable:
            now = time.monotonic()
            if worker is None or now - getattr(self, "_last_probe", 0.0) > 10.0:
                self._last_probe = now
                worker = self._devworker = _make_probed_worker(
                    attempts=2, first_budget=30.0)
        return worker.submit(fn, timeout)

    def _fetch_with_timeout(self, tree, timeout: float):
        """Overlapped device->host fetch with loss detection; None on a
        lost transfer."""
        out = self._device_job(lambda: _fetch_tree(tree), timeout)
        return None if out is _LOST else out

    def _run_block_resilient(self, host_aux):
        """One device dispatch + tap fetch with lost-operation recovery.
        Keeps the pre-block state so a retry replays identical math; on
        total failure the block's output is dropped and the engine stays
        alive (drop-on-lag posture, monitor.rs:164-176 — applied to the
        device instead of the codec).  The device lock is held by the
        ENGINE thread around each attempt so an in-flight warm/compile on
        the DeviceHost never interleaves; acquisition is bounded so a
        wedged lock-holder cannot take the engine down with it."""
        import jax

        prev_state = self._state

        def _attempt():
            new_state, taps = self._patch.run(self._aux, host_aux, prev_state)
            return new_state, _fetch_tree(taps)

        # a cold program compiles inside its first run — give it time
        warmed = getattr(self._patch, "_warmed", False)
        timeout = self.DISPATCH_TIMEOUT if warmed else 180.0
        if not self._device_lock.acquire(timeout=60.0):
            self.block_faults["dropped"] += 1
            log.error("device lock unavailable for 60 s; skipping block")
            return prev_state, {}
        try:
            for attempt in range(1 + self.DISPATCH_RETRIES):
                if attempt:
                    self.block_faults["redispatched"] += 1
                out = self._device_job(_attempt, timeout)
                if out is not _LOST:
                    self._patch._warmed = True
                    return out
                self.block_faults["lost"] += 1
                log.error(
                    "device block lost (attempt %d/%d); re-dispatching",
                    attempt + 1,
                    1 + self.DISPATCH_RETRIES,
                )
        finally:
            self._device_lock.release()
        self.block_faults["dropped"] += 1
        log.error("device block lost %d times; dropping block output",
                  1 + self.DISPATCH_RETRIES)
        return prev_state, {}

    def flush_inflight(self) -> Dict[ModuleId, Indication]:
        """Route any deferred blocks (pipelined mode) — call before
        checkpoint/stop so no audio is lost."""
        indications = {}
        while self._inflight:
            indications.update(self._route_taps(*self._inflight.popleft()))
        return indications

    def _route_taps(self, t0, S, taps, video_buffers) -> Dict[ModuleId, Indication]:
        indications: Dict[ModuleId, Indication] = {}
        now = time.monotonic()
        # fetch any tap arrays still on device in one serialized section;
        # the per-sink logic below then works on plain numpy.  (In the
        # synchronous path taps arrive already fetched by
        # _run_block_resilient — skip the hop.)
        import jax

        from mixlab_tpu.utils.devhost import device_call

        def _interleave(pair, n):
            """Stereo taps arrive channel-major as an (L, R) pair of
            [T, spt] arrays; host consumers want interleaved [S, 2]."""
            l, r = pair
            return np.stack(
                [np.asarray(l).reshape(n), np.asarray(r).reshape(n)], axis=1
            )

        if any(
            hasattr(leaf, "is_ready")
            for leaf in jax.tree_util.tree_leaves(taps)
        ):

            def _fetch():
                with self._device_lock:
                    return _fetch_tree(taps)

            taps = device_call(_fetch)
        for k, tp in taps.items():
            mid = ModuleId(int(k))
            entry = self.ws.modules.get(mid)
            if entry is None:
                continue
            kind = entry.params.kind
            if kind in ("Monitor", "StreamOutput"):
                pipe = self._monitor_pipes.get(mid)
                if pipe is not None:
                    video = self._video_input(mid, 0, video_buffers)
                    pipe.push((t0, _interleave(tp["audio"], S), video))
            elif kind == "Plotter":
                count = self._plotter_counts.get(mid, 0)
                n = self.block.n_ticks
                audio = tp.get("audio")
                for j in range(n):
                    count += 1
                    if count % 6 == 0 and audio is not None:
                        lch, rch = audio
                        indications[mid] = Indication(
                            "Plotter",
                            p.PlotterIndication(
                                (
                                    tuple(float(x) for x in np.asarray(lch[j])),
                                    tuple(float(x) for x in np.asarray(rch[j])),
                                )
                            ),
                        )
                self._plotter_counts[mid] = count
            elif kind == "OutputDevice":
                # L/R → device-channel mapping (output_device.rs:188-208):
                # unmapped engine channels are dropped (device channel stays
                # silent), and clip is detected on mapped samples only.
                dev_params = entry.params.params
                stream = self._audio_streams.get(mid)
                nch = stream.channels if stream is not None else 2
                audio = _interleave(tp["audio"], S)
                scratch = np.zeros((S, nch), dtype=np.float32)
                clip = False
                for src, dst in ((0, dev_params.left), (1, dev_params.right)):
                    if dst is not None and 0 <= dst < nch:
                        col = audio[:, src]
                        clip = clip or bool(np.any(np.abs(col) > 1.0))
                        scratch[:, dst] = col
                if clip:
                    self._clip_times[mid] = now
                if stream is not None:
                    if not stream.write(scratch):
                        self._lag_times[mid] = now
                clip = temporal_warning(
                    now - self._clip_times[mid] if mid in self._clip_times else None
                )
                lag = temporal_warning(
                    now - self._lag_times[mid] if mid in self._lag_times else None
                )
                prev = self.ws.indications.get(mid)
                base = prev.value if prev is not None and prev.value else p.OutputDeviceIndication()
                ind = Indication(
                    "OutputDevice",
                    p.OutputDeviceIndication(
                        clip=clip,
                        lag=lag,
                        default_device=base.default_device,
                        devices=base.devices,
                    ),
                )
                if prev != ind:
                    indications[mid] = ind

        for mid, ind in indications.items():
            self.ws.indications[mid] = ind
            self._log_op(p.SUUpdateModuleIndication(mid, ind))
        return indications

    def _video_input(self, mid: ModuleId, index: int, buffers) -> Optional[object]:
        entry = self.ws.modules[mid]
        if index >= len(entry.inputs):
            return None
        if entry.inputs[index].line_type != LineType.VIDEO:
            return None
        out = self.ws.connections.get(InputId(mid, index))
        if out is None:
            return None
        return buffers.get(out)


def _same_structure(a, b) -> bool:
    import jax

    try:
        ta = jax.tree.structure(a)
        tb = jax.tree.structure(b)
        if ta != tb:
            return False
        la = jax.tree.leaves(a)
        lb = jax.tree.leaves(b)
        return all(
            getattr(x, "shape", None) == getattr(y, "shape", None) for x, y in zip(la, lb)
        )
    except Exception:
        return False
