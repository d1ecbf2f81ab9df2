"""CLI entry point: ``python -m mixlab_tpu [--listen HOST:PORT] [--sample-rate N] workspace.mixlab``.

Rebuild of ``src/main.rs``: structopt-style options (--listen defaulting to
127.0.0.1:8000, positional workspace path), logging init, then the server
event loop on the single disambiguated port.

Thread layout differs from the reference deliberately: the MAIN thread is
the accelerator home thread (it warms the initial program and then serves
compile jobs via utils/devhost.py — see that module for why), the asyncio
server runs on a side thread, and the engine has its own realtime thread,
mirroring the reference's engine-thread split (src/engine.rs:78-96).
"""

from __future__ import annotations

import argparse
import os
import asyncio
import logging
import signal
import threading


def main():
    parser = argparse.ArgumentParser(prog="mixlab_tpu")
    parser.add_argument("--listen", default="127.0.0.1:8000", help="listen address")
    parser.add_argument(
        "--sample-rate", type=int, default=44_100, help="engine sample rate"
    )
    parser.add_argument(
        "--block-ticks",
        type=int,
        default=int(os.environ.get("MIXLAB_BLOCK_TICKS", "4")),
        help="engine ticks per device dispatch (latency/overhead trade; "
        "4 = 67 ms blocks)",
    )
    parser.add_argument("workspace_path", help="project file (.mixlab)")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)

    from mixlab_tpu.utils.platform import apply_env_platform, enable_compile_cache

    apply_env_platform()
    enable_compile_cache()

    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.engine.project import open_or_create
    from mixlab_tpu.server.app import run_server
    from mixlab_tpu.utils.devhost import DeviceHost

    # Backend init happens on the main thread, the device home thread that
    # later serves compile jobs (utils/devhost.py), before any worker
    # thread exists.
    import jax
    import jax.numpy as _jnp

    float(_jnp.zeros((8,), _jnp.float32).sum())
    dev = jax.devices()[0]
    logging.info("device backend ready: %s %s x%d", dev.platform,
                 dev.device_kind, len(jax.devices()))

    host, _, port = args.listen.rpartition(":")
    project = open_or_create(
        args.workspace_path,
        EngineConfig(sample_rate=args.sample_rate),
        block_ticks=args.block_ticks,
    )

    # Warm the initial program ON MAIN before the engine thread exists:
    # first-compile must happen on the jax home thread (utils/devhost.py)
    logging.info("compiling initial patch...")
    project.engine.tick_once()
    project.engine.flush_inflight()
    project.engine.tick = 0
    logging.info("initial patch ready")

    stop_serving = threading.Event()
    loop_ready: dict = {}

    async def amain():
        tcp, _server = await run_server(project, host or "127.0.0.1", int(port))
        logging.info("mixlab listening on http://%s", args.listen)
        stop = asyncio.Event()
        loop_ready["loop"] = asyncio.get_running_loop()
        loop_ready["stop"] = stop
        await stop.wait()
        tcp.close()
        # Python 3.12's Server.wait_closed() waits for every live handler
        # coroutine; a monitor pump whose segments stalled would hold
        # shutdown hostage — bound the wait instead
        try:
            await asyncio.wait_for(tcp.wait_closed(), timeout=5.0)
        except (asyncio.TimeoutError, TimeoutError):
            logging.warning("open connections did not drain; forcing exit")
        logging.info("mixlab shutting down")

    def run_loop():
        try:
            asyncio.run(amain())
        except Exception:
            logging.exception("server loop failed")
        finally:
            stop_serving.set()

    def request_stop(*_sig):
        # signal handlers run on main; relay to both the asyncio loop and
        # the device-host serve loop
        stop_serving.set()
        loop = loop_ready.get("loop")
        stop = loop_ready.get("stop")
        if loop is not None and stop is not None:
            loop.call_soon_threadsafe(stop.set)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, request_stop)
        except (ValueError, OSError):
            pass

    server_thread = threading.Thread(target=run_loop, name="server-loop")
    server_thread.start()
    try:
        # main thread = device home: executes compile/warm jobs for edits
        DeviceHost.instance().serve_forever(stop_serving)
        request_stop()
        server_thread.join(timeout=15.0)
    except KeyboardInterrupt:
        request_stop()
    finally:
        project.engine.stop()
        project.close()
        # persistence is flushed; daemon threads may still be inside native
        # code (a device dispatch or a codec call) — normal
        # interpreter teardown races them and can SIGSEGV, so exit hard
        logging.shutdown()
        os._exit(0)


if __name__ == "__main__":
    main()
