"""DeviceHost: pins compile-class device work to the jax "home" thread.

The live server keeps jit compilation and each program's first execution
on the thread that imported jax (the process main thread), while the
engine thread runs steady-state execute/fetch.  Compiles then never run on
the engine thread, whose 60 Hz schedule they would stall, and they never
race each other.

So the live server dedicates the MAIN thread to device work: the asyncio
loop moves to a side thread (``__main__.py``) and main runs
``DeviceHost.serve_forever``, executing submitted compile/warm jobs.  When
no host is serving (offline renders, tests, CPU backend — all of which
drive compilation from their own main thread anyway), ``call`` simply runs
the job inline on the caller.

The reference has no analogue: rustc compiles ahead of time and cranelift
isn't involved; the closest idea is its insistence that one thread owns the
workspace (src/engine/workspace.rs:148-170) — this is the same discipline
applied to the accelerator client.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)


class DeviceHost:
    _instance: Optional["DeviceHost"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._serving = False
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def instance(cls) -> "DeviceHost":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = DeviceHost()
            return cls._instance

    @property
    def serving(self) -> bool:
        return self._serving

    def serve_forever(self, stop: threading.Event, poll: float = 0.25):
        """Run on the home thread; executes submitted jobs until ``stop``."""
        self._thread = threading.current_thread()
        self._serving = True
        try:
            while not stop.is_set():
                try:
                    job = self._q.get(timeout=poll)
                except queue.Empty:
                    continue
                job()
        finally:
            self._serving = False
            # unblock any caller that raced shutdown
            while True:
                try:
                    self._q.get_nowait()()
                except queue.Empty:
                    break

    def call(self, fn: Callable, timeout: Optional[float] = None):
        """Run ``fn`` on the home thread (blocking the caller); inline when
        no host is serving or when already on the home thread."""
        if not self._serving or threading.current_thread() is self._thread:
            return fn()
        done = threading.Event()
        box = {}

        def job():
            try:
                box["r"] = fn()
            except BaseException as e:  # delivered to the caller
                box["e"] = e
            finally:
                done.set()

        self._q.put(job)
        if not done.wait(timeout):
            raise TimeoutError("device host job timed out")
        if "e" in box:
            raise box["e"]
        return box["r"]


def device_call(fn: Callable, timeout: Optional[float] = None):
    return DeviceHost.instance().call(fn, timeout)
