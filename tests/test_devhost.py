"""Device-discipline machinery (utils/devhost.py, engine device workers).

These are the live server's guards around device calls (see
utils/devlock.py): a DeviceHost pinning compile-class work to the jax home
thread, and replaceable timed device workers whose lost jobs are abandoned
and counted rather than wedging the engine."""

import threading
import time

import pytest

from mixlab_tpu.engine.engine import _LOST, _DeviceWorker, _make_probed_worker
from mixlab_tpu.utils.devhost import DeviceHost, device_call


def test_device_call_inline_when_not_serving():
    host = DeviceHost()
    calls = []
    assert host.call(lambda: calls.append(threading.current_thread()) or 42) == 42
    assert calls[0] is threading.current_thread()


def test_device_host_runs_jobs_on_home_thread():
    host = DeviceHost()
    stop = threading.Event()
    home_box = {}

    def serve():
        home_box["thread"] = threading.current_thread()
        host.serve_forever(stop)

    t = threading.Thread(target=serve)
    t.start()
    try:
        deadline = time.time() + 5
        while not host.serving and time.time() < deadline:
            time.sleep(0.01)
        assert host.serving
        ran_on = host.call(lambda: threading.current_thread())
        assert ran_on is home_box["thread"]
        # exceptions propagate to the caller
        with pytest.raises(ValueError, match="boom"):
            host.call(lambda: (_ for _ in ()).throw(ValueError("boom")))
        # nested call from the home thread runs inline (no deadlock)
        assert host.call(lambda: host.call(lambda: "nested")) == "nested"
    finally:
        stop.set()
        t.join(timeout=5)
    assert not host.serving
    # after shutdown, calls run inline again
    assert host.call(lambda: "inline") == "inline"


def test_device_worker_timeout_marks_unusable():
    w = _DeviceWorker()
    w.start()
    assert w.submit(lambda: 7, 5.0) == 7
    blocker = threading.Event()
    out = w.submit(lambda: blocker.wait(30), 0.2)  # simulated lost op
    assert out is _LOST
    assert not w.usable
    blocker.set()  # release the abandoned thread


def test_device_worker_propagates_exceptions():
    w = _DeviceWorker()
    w.start()
    with pytest.raises(RuntimeError, match="kaput"):
        w.submit(lambda: (_ for _ in ()).throw(RuntimeError("kaput")), 5.0)
    assert w.usable  # an exception is a result, not a loss


def test_probed_worker_passes_initiation():
    w = _make_probed_worker()
    assert w.usable
    assert w.submit(lambda: "alive", 5.0) == "alive"


def test_failed_probe_raises_instead_of_degrading(monkeypatch):
    """A device that never answers the probe stops start-up: there is no
    degraded mode that would hide a dead device."""
    from mixlab_tpu.engine.engine import DeviceUnavailable

    monkeypatch.setattr(_DeviceWorker, "submit", lambda self, fn, t: _LOST)
    with pytest.raises(DeviceUnavailable):
        _make_probed_worker(attempts=2, first_budget=0.1)


def test_engine_drops_block_after_repeated_losses(monkeypatch):
    """A patch whose dispatch never completes must not wedge the engine:
    bounded retries, then the block is dropped and the previous state
    kept."""
    from mixlab_tpu import protocol as p
    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.engine.engine import Engine
    from mixlab_tpu.engine.graph import Workspace

    ws = Workspace()
    ws.create_module(p.ModuleParams(
        "Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
    eng = Engine(workspace=ws, cfg=EngineConfig(sample_rate=44_100))
    eng.DISPATCH_TIMEOUT = 0.2
    eng.tick_once()  # warm normally
    state_before = eng._state

    hang = threading.Event()

    def wedged_run(aux, host_aux, state):
        hang.wait(30)
        raise AssertionError("unreachable in test")

    monkeypatch.setattr(eng._patch, "run", wedged_run)
    t0 = time.time()
    eng.tick_once()  # 1 + DISPATCH_RETRIES timed attempts, then drop
    elapsed = time.time() - t0
    assert elapsed < 10, "lost dispatch wedged the engine"
    assert eng._state is state_before  # block dropped, state retained
    assert eng.block_faults == {"lost": 3, "redispatched": 2, "dropped": 1}
    hang.set()


def test_abandoned_swap_retries_until_adopted(monkeypatch):
    """A swap abandoned after lost warm runs must retry and
    eventually land — an edit never silently stays un-adopted forever."""
    from mixlab_tpu import protocol as p
    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.engine.engine import Engine
    from mixlab_tpu.engine.graph import Workspace

    eng = Engine(workspace=Workspace(), cfg=EngineConfig(sample_rate=44_100))
    fails = {"n": 2}
    real_fetch = Engine._fetch_with_timeout

    def flaky_fetch(self, tree, timeout):
        if fails["n"] > 0:
            fails["n"] -= 1
            return None  # simulated lost transfer
        return real_fetch(self, tree, timeout)

    monkeypatch.setattr(Engine, "_fetch_with_timeout", flaky_fetch)
    monkeypatch.setattr(Engine, "DISPATCH_RETRIES", 0)  # 1 warm try per job

    # make retry fast for the test
    real_wait = eng._stop.wait
    monkeypatch.setattr(eng._stop, "wait",
                        lambda t=None: real_wait(0.05 if t else None))

    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator",
                           p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry())))
        deadline = time.time() + 30
        while time.time() < deadline:
            if [str(m.value) for m in eng._patch.order]:
                break
            time.sleep(0.1)
        assert eng._patch.order, "swap never landed despite retries"
        assert fails["n"] == 0  # both simulated losses were consumed
    finally:
        eng.stop()
