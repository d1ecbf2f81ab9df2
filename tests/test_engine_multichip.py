"""The LIVE Engine over a device mesh (VERDICT r4 ask #7).

parallel/stems.py was exercised only by bench/dryrun/test programs; these
tests run the actual Engine — tick loop, client ops, async compile-and-swap,
tap routing — with its DSP lowered to the stems shard_map program on the
8-device virtual CPU mesh (conftest forces
xla_force_host_platform_device_count=8):

  * psum-mixdown tap equality vs the single-device engine on the same
    workspace (uneven 5 stems over 8 devices: pad stems mix exact zeros),
  * a STRUCTURAL edit mid-run (CreateModule + CreateConnection over
    client_update) recompiles the shard_map program and the engine keeps
    ticking with the new module audible in the mixdown,
  * the realtime thread variant: edit lands through the async
    compile-and-swap path while the 60 Hz loop runs.
"""

import queue
import time

import numpy as np
import pytest

import jax

from mixlab_tpu import protocol as p
from mixlab_tpu.engine.config import EngineConfig
from mixlab_tpu.engine.engine import Engine
from mixlab_tpu.engine.graph import Workspace
from mixlab_tpu.parallel.stems import StemsPatch, make_mesh
from mixlab_tpu.protocol import InputId, OutputId

CFG = EngineConfig(sample_rate=48_000)
N_STEMS = 5  # deliberately NOT a device multiple (8 devices)


def template():
    ws = Workspace()
    o = ws.create_module(p.ModuleParams(
        "Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
    a = ws.create_module(p.ModuleParams(
        "Amplifier", p.AmplifierParams(amplitude=0.5)))
    m = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(InputId(a, 0), OutputId(o, 1))
    ws.connect(InputId(m, 1), OutputId(a, 0))
    return ws, o, a, m


def capture_taps(eng):
    """Wrap _route_taps to record every block's taps pytree."""
    captured = []
    orig = eng._route_taps

    def wrapper(t0, S, taps, video_buffers):
        captured.append((t0, taps))
        return orig(t0, S, taps, video_buffers)

    eng._route_taps = wrapper
    return captured


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def test_mixdown_tap_matches_single_device_engine(mesh):
    ws1, *_ = template()
    ws2, *_ = template()
    eng_multi = Engine(workspace=ws1, cfg=CFG, block_ticks=2,
                       patch_compiler=StemsPatch.compiler(mesh, N_STEMS))
    eng_single = Engine(workspace=ws2, cfg=CFG, block_ticks=2)
    taps_m = capture_taps(eng_multi)
    taps_s = capture_taps(eng_single)
    for _ in range(3):
        eng_multi.tick_once()
        eng_single.tick_once()
    assert len(taps_m) == len(taps_s) == 3
    for (t0m, tm), (t0s, tsg) in zip(taps_m, taps_s):
        assert t0m == t0s
        (key,) = tm.keys()
        lm, rm = (np.asarray(x) for x in tm[key]["audio"])
        ls, rs = (np.asarray(x) for x in tsg[key]["audio"])
        # mixdown of N identical stems = N x the single render; pads are
        # exact zeros (uneven 5/8 sharding)
        np.testing.assert_allclose(lm, N_STEMS * ls, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rm, N_STEMS * rs, rtol=1e-6, atol=1e-6)
        assert np.any(lm != 0.0)


def test_structural_edit_mid_run_direct_drive(mesh):
    ws, o, a, m = template()
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=2,
                 patch_compiler=StemsPatch.compiler(mesh, N_STEMS))
    captured = capture_taps(eng)
    sid, state, events = eng.connect_session()
    eng.tick_once()
    # structural edit: add a second oscillator into a new mixer... keep it
    # simple — connect a new FmSine straight into the monitor, replacing
    # the amplifier feed
    eng.client_update(sid, p.WorkspaceMessage(1, p.CreateModule(
        p.ModuleParams("Oscillator",
                       p.OscillatorParams(220.0, p.Waveform.SAW)),
        p.WindowGeometry())))
    new_mid = max(eng.ws.modules, key=lambda mid: mid.value)
    eng.client_update(sid, p.WorkspaceMessage(2, p.CreateConnection(
        InputId(m, 1), OutputId(new_mid, 1))))
    eng.tick_once()
    assert len(captured) == 2
    (key,) = captured[1][1].keys()
    l2 = np.asarray(captured[1][1][key]["audio"][0])

    # reference: single-device render of the EDITED graph at the same t0,
    # times N_STEMS
    ws_ref, o_r, a_r, m_r = template()
    ws_ref.create_module(p.ModuleParams(
        "Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW)))
    new_ref = max(ws_ref.modules, key=lambda mid: mid.value)
    ws_ref.connect(InputId(m_r, 1), OutputId(new_ref, 1))
    ref = Engine(workspace=ws_ref, cfg=CFG, block_ticks=2)
    ref_taps = capture_taps(ref)
    ref.tick_once()
    ref.tick_once()
    (rkey,) = ref_taps[1][1].keys()
    l_ref = np.asarray(ref_taps[1][1][rkey]["audio"][0])
    np.testing.assert_allclose(l2, N_STEMS * l_ref, rtol=1e-6, atol=1e-6)


def test_structural_edit_under_realtime_thread(mesh):
    """The async compile-and-swap path: the 60 Hz thread keeps ticking
    while the shard_map recompile happens off-thread; the new module
    becomes audible after the swap."""
    ws, o, a, m = template()
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=6,
                 patch_compiler=StemsPatch.compiler(mesh, N_STEMS))
    captured = capture_taps(eng)
    eng.start()
    try:
        sid, state, events = eng.connect_session()
        deadline = time.monotonic() + 10
        while not captured and time.monotonic() < deadline:
            time.sleep(0.05)
        assert captured, "engine produced no blocks"
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Trigger", p.GateState.OPEN),
            p.WindowGeometry())))
        trig_mid = None
        deadline = time.monotonic() + 10
        while trig_mid is None and time.monotonic() < deadline:
            trig_mid = next(
                (mid for mid, e in eng.ws.modules.items()
                 if e.params.kind == "Trigger"), None)
            time.sleep(0.05)
        assert trig_mid is not None
        # wait for the swap: the new module appears in the running order
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if trig_mid in eng._patch.order:
                break
            time.sleep(0.1)
        assert trig_mid in eng._patch.order, "swap never adopted"
        n_before = len(captured)
        deadline = time.monotonic() + 10
        while len(captured) <= n_before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(captured) > n_before, "engine stalled after the swap"
        assert eng._thread.is_alive()
    finally:
        eng.stop()


def _wait_for(cond, seconds, what):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


@pytest.mark.parametrize("realtime", [False, True], ids=["direct", "thread"])
@pytest.mark.parametrize("n_devices", [1, 8])
def test_each_program_compiles_once_without_block_faults(n_devices, realtime):
    """Through a structural edit, each StemsPatch program is compiled once:
    its warm run (realtime swap) and every dispatch share one executable,
    because inputs are placed on the mesh as the program's outputs are.  A
    recompile inside a warmed dispatch could outlast DISPATCH_TIMEOUT and be
    counted as a lost block; none is lost, re-dispatched or dropped."""
    ws, o, a, m = template()
    # an EqThree on the oscillator's mono output into the amplifier's mono
    # input: its filter state is what came back replicated from a one-device
    # mesh before the program's output placement was pinned
    eq = ws.create_module(p.ModuleParams("EqThree", p.EqThreeParams(
        p.Decibel(3.0), p.Decibel(0.0), p.Decibel(-3.0))))
    ws.connect(InputId(eq, 0), OutputId(o, 0))
    ws.connect(InputId(a, 1), OutputId(eq, 0))
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=4,
                 patch_compiler=StemsPatch.compiler(make_mesh(n_devices),
                                                    N_STEMS))
    captured = capture_taps(eng)
    first = eng._patch
    send = eng.update if realtime else eng.client_update
    if realtime:
        eng.start()
    try:
        sid, _, _ = eng.connect_session()
        for _ in range(2):
            if not realtime:
                eng.tick_once()
        _wait_for(lambda: len(captured) >= 2, 30, "no blocks")
        before = set(eng.ws.modules)
        send(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator",
                           p.OscillatorParams(220.0, p.Waveform.SAW)),
            p.WindowGeometry())))
        _wait_for(lambda: set(eng.ws.modules) - before, 10, "no module")
        (new,) = set(eng.ws.modules) - before
        send(sid, p.WorkspaceMessage(2, p.CreateConnection(
            InputId(m, 1), OutputId(new, 1))))
        _wait_for(lambda: new in eng._patch.order, 60, "edit never adopted")
        n = len(captured)
        if not realtime:
            for _ in range(2):
                eng.tick_once()
        _wait_for(lambda: len(captured) >= n + 2, 30, "stalled after swap")
    finally:
        eng.stop()
    assert eng._patch is not first
    assert first._fn._cache_size() == 1
    assert eng._patch._fn._cache_size() == 1
    assert eng.block_faults == {"lost": 0, "redispatched": 0, "dropped": 0}
