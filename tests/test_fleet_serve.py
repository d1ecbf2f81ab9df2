"""Fleet serving: N live sessions through ONE vmapped dispatch.

The fleet's device throughput needs a product shape —
real sessions joining/editing/monitoring with their DSP executed as one
vmapped program per block, host fan-out included.  These tests pin the
correctness half on CPU:

  * join/leave/edit isolation under vmap (one session's edit never leaks
    into another's monitor tap),
  * slot taps EXACTLY equal a dedicated single-patch render of the same
    params (the vmapped program is compile_patch's own block program,
    compiler.py:158-189, so equality is exact, not approximate),
  * structural ops rejected typed with rollback,
  * the real WebSocket route end to end: join -> WorkspaceState -> edit ->
    Sync -> framed i16 PCM monitor blocks, multiple concurrent clients.
"""

import asyncio
import json
import queue
import struct
import time

import numpy as np
import pytest

from mixlab_tpu import protocol as p
from mixlab_tpu.engine.compiler import compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace
from mixlab_tpu.protocol import InputId, OutputId
from mixlab_tpu.server.fleet_serve import FleetEngine, FleetServeApp
from tests.test_server import mask_frame, ws_connect, ws_recv

CFG = EngineConfig(sample_rate=48_000)
BLOCK_TICKS = 3


def small_template():
    """osc -> amp -> monitor (config1 shape; cheap CPU compile)."""
    ws = Workspace()
    o = ws.create_module(p.ModuleParams(
        "Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
    a = ws.create_module(p.ModuleParams(
        "Amplifier", p.AmplifierParams(amplitude=0.5)))
    m = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(InputId(a, 0), OutputId(o, 1))
    ws.connect(InputId(m, 1), OutputId(a, 0))
    return ws, o, a, m


class FakeSub:
    """Collects monitor packets synchronously (direct-drive tests)."""

    def __init__(self):
        self.packets = []

    def push_threadsafe(self, pkt):
        self.packets.append(pkt)


def make_engine(capacity=4):
    ws, o, a, m = small_template()
    eng = FleetEngine(ws, capacity, CFG, block_ticks=BLOCK_TICKS)
    return eng, (ws, o, a, m)


def join(eng):
    done = queue.Queue(maxsize=1)
    eng._process_cmd(("join", done))
    return done.get_nowait()


def edit_freq(eng, slot, osc_mid, freq, seq=1):
    msg = p.WorkspaceMessage(seq, p.UpdateModuleParams(
        osc_mid, p.ModuleParams("Oscillator",
                                p.OscillatorParams(freq, p.Waveform.SINE))))
    eng._process_cmd(("op", slot, msg))


def pcm_of(sub, idx=-1):
    pkt = sub.packets[idx]
    header, payload = pkt.split(b"\n", 1)
    h = json.loads(header)
    pcm = np.frombuffer(payload, dtype=np.int16).reshape(-1, 2)
    return h, pcm


def single_render(ws, t0=0, n_blocks=1):
    """Dedicated single-patch reference render of the same workspace."""
    patch = compile_patch(ws, CFG, BlockSpec(BLOCK_TICKS))
    state = patch.init_state(ws)
    out = []
    for b in range(n_blocks):
        t = t0 + b * BLOCK_TICKS * CFG.samples_per_tick
        state, taps = patch.run(patch.prepare_aux(ws), patch.host_aux(t), state)
        (mon_key,) = taps.keys()
        l, r = taps[mon_key]["audio"]
        pcm = np.empty((l.size, 2), dtype=np.int16)
        pcm[:, 0] = (np.clip(np.asarray(l).reshape(-1), -1, 1) * 32767).astype(np.int16)
        pcm[:, 1] = (np.clip(np.asarray(r).reshape(-1), -1, 1) * 32767).astype(np.int16)
        out.append(pcm)
    return np.concatenate(out)


def test_join_edit_isolation_and_exactness():
    eng, (tmpl, o, a, m) = make_engine()
    s0, s1 = join(eng), join(eng)
    assert s0.index == 0 and s1.index == 1
    edit_freq(eng, s0, o, 880.0)
    assert s0.events.get_nowait() == ("sync", 1)

    sub0, sub1 = FakeSub(), FakeSub()
    s0.monitors.append(sub0)
    s1.monitors.append(sub1)
    # issue-ahead pipeline: N+1 blocks deliver N tap packets
    eng._block_once()
    eng._block_once()
    eng._block_once()
    pcm0 = np.concatenate([pcm_of(sub0, i)[1] for i in range(2)])
    pcm1 = np.concatenate([pcm_of(sub1, i)[1] for i in range(2)])
    assert not np.array_equal(pcm0, pcm1)  # the edit isolated to s0

    # each slot's tap EXACTLY equals a dedicated render of its params
    ws880, o2, a2, m2 = small_template()
    ws880.update_params(o2, p.ModuleParams(
        "Oscillator", p.OscillatorParams(880.0, p.Waveform.SINE)))
    assert np.array_equal(pcm0, single_render(ws880, n_blocks=2))
    assert np.array_equal(pcm1, single_render(tmpl, n_blocks=2))


def test_leave_frees_slot_and_resets_state():
    eng, (tmpl, o, a, m) = make_engine(capacity=2)
    s0 = join(eng)
    edit_freq(eng, s0, o, 660.0)
    sub = FakeSub()
    s0.monitors.append(sub)
    eng._block_once()
    eng._process_cmd(("leave", s0))
    # rejoin gets the freed slot back, with template params and fresh state
    s0b = join(eng)
    assert s0b.index == 0
    sub2 = FakeSub()
    s0b.monitors.append(sub2)
    t0_before = eng.tick * CFG.samples_per_tick
    eng._block_once()
    eng._block_once()  # pipeline: the first block's taps deliver here
    # the previous occupant's in-flight 660 Hz block must NOT reach the
    # new session (join-time gating), so packet 0 is the fresh render
    _, pcm = pcm_of(sub2, 0)
    assert np.array_equal(pcm, single_render(tmpl, t0=t0_before))


def test_capacity_exhaustion_returns_none():
    eng, _ = make_engine(capacity=2)
    assert join(eng) is not None and join(eng) is not None
    assert join(eng) is None


def test_structural_ops_rejected_with_rollback():
    eng, (tmpl, o, a, m) = make_engine(capacity=1)
    s = join(eng)
    # graph-shape op: rejected typed
    msg = p.WorkspaceMessage(5, p.CreateModule(
        p.ModuleParams("Oscillator", p.OscillatorParams(100.0, p.Waveform.SINE)),
        p.WindowGeometry()))
    eng._process_cmd(("op", s, msg))
    assert s.events.get_nowait() == ("sync", 5)
    ev = s.events.get_nowait()
    assert ev[0] == "error" and "structural" in ev[2]

    # structural-key param change (waveform): rejected AND rolled back
    msg = p.WorkspaceMessage(6, p.UpdateModuleParams(
        o, p.ModuleParams("Oscillator",
                          p.OscillatorParams(440.0, p.Waveform.SQUARE))))
    eng._process_cmd(("op", s, msg))
    assert s.events.get_nowait() == ("sync", 6)
    assert s.events.get_nowait()[0] == "error"
    assert s.ws.modules[o].params.params.waveform == p.Waveform.SINE
    # engine still renders (pipeline: taps arrive one block later)
    sub = FakeSub()
    s.monitors.append(sub)
    eng._block_once()
    eng._block_once()
    assert sub.packets


def test_ws_end_to_end_multiple_sessions():
    """Real sockets: three concurrent clients join, one edits, all stream
    framed i16 PCM; Sync echoes; the edited session's audio differs."""
    eng, (tmpl, o, a, m) = make_engine(capacity=4)
    eng.start()
    app = FleetServeApp(eng)

    async def client(port, freq=None):
        reader, writer = await ws_connect("127.0.0.1", port, "/fleet")
        opc, payload = await asyncio.wait_for(ws_recv(reader), 5)
        joined = json.loads(payload)
        assert joined["t"] == "Joined"
        opc, payload = await asyncio.wait_for(ws_recv(reader), 5)
        env = json.loads(payload)
        assert env["kind"] == "WorkspaceState"
        if freq is not None:
            op = {"t": "WorkspaceMessage", "sequence": 1,
                  "op": {"t": "UpdateModuleParams", "module_id": o.value,
                         "params": {"kind": "Oscillator",
                                    "params": {"t": "OscillatorParams",
                                               "freq": freq,
                                               "waveform": "sine"}}}}
            env = json.dumps({"v": 1, "kind": "Workspace", "m": op})
            writer.write(mask_frame(1, env.encode()))
            await writer.drain()
        pcms, synced = [], freq is None
        deadline = time.monotonic() + 15
        while (len(pcms) < 3 or not synced) and time.monotonic() < deadline:
            opc, payload = await asyncio.wait_for(ws_recv(reader), 10)
            if opc == 1:
                msg = json.loads(payload)
                if msg.get("t") == "Sync":
                    assert msg["sequence"] == 1
                    synced = True
                assert msg.get("t") != "Error"
            elif opc == 2:
                header, body = payload.split(b"\n", 1)
                h = json.loads(header)
                assert h["t"] == "pcm" and h["rate"] == CFG.sample_rate
                pcms.append((h["t0"],
                             np.frombuffer(body, np.int16).reshape(-1, 2)))
        assert synced and len(pcms) >= 3
        writer.close()
        return joined["slot"], pcms

    async def go():
        port = await app.serve()
        a_res, b_res, c_res = await asyncio.gather(
            client(port), client(port, freq=880.0), client(port))
        await app.shutdown()
        return a_res, b_res, c_res

    try:
        (sa, pa), (sb, pb), (sc, pc) = asyncio.run(go())
    finally:
        eng.stop()
    assert len({sa, sb, sc}) == 3
    # align on a common t0 present in all three streams (post-edit for b)
    tb = {t0 for t0, _ in pb}
    common = sorted(({t0 for t0, _ in pa} & tb & {t0 for t0, _ in pc}))
    assert common, "no overlapping blocks across sessions"
    t0 = common[-1]
    get = lambda pcms: next(x for t, x in pcms if t == t0)
    assert np.array_equal(get(pa), get(pc))       # same params -> same audio
    assert np.any(get(pa) != 0)
    # b's stream eventually reflects its 880 Hz edit
    ws880, o2, a2, m2 = small_template()
    ws880.update_params(o2, p.ModuleParams(
        "Oscillator", p.OscillatorParams(880.0, p.Waveform.SINE)))
    patch = compile_patch(ws880, CFG, BlockSpec(BLOCK_TICKS))
    st = patch.init_state(ws880)
    t0b, pcm_b = pb[-1]
    st, taps = patch.run(patch.prepare_aux(ws880), patch.host_aux(t0b), st)
    (mon_key,) = taps.keys()
    l, _ = taps[mon_key]["audio"]
    want_l = (np.clip(np.asarray(l).reshape(-1), -1, 1) * 32767).astype(np.int16)
    # state is block-invariant for this graph (osc phase is host-derived),
    # so a fresh-state render at t0b matches the live stream exactly
    assert np.array_equal(pcm_b[:, 0], want_l)
