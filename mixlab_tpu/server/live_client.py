"""Drive a live server end to end from outside, as a browser would.

:func:`drive_live` boots ``python -m mixlab_tpu --listen`` on a fresh
project, speaks raw RFC 6455 (offering permessage-deflate), sends a list of
workspace ops over the wire, streams fMP4 segments from ``/_monitor``,
reads ``/_metrics`` every half second from the first op on, then SIGTERMs
the server expecting exit 0 with the edits persisted.  ``tools/drive_live.py`` and ``chip_smoke.py`` run it.

The caller's process must hold no device: the server is the one process on
the card.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import sqlite3
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[2]

FAULT_METRICS = ("mixlab_engine_blocks_lost_total",
                 "mixlab_engine_blocks_redispatched_total",
                 "mixlab_engine_blocks_dropped_total")


class LiveDriveError(RuntimeError):
    pass


def mask_frame(opcode: int, payload: bytes) -> bytes:
    mask = os.urandom(4)
    head = bytearray([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head.append(0x80 | n)
    elif n < 0x10000:
        head.append(0x80 | 126)
        head += struct.pack(">H", n)
    else:
        head.append(0x80 | 127)
        head += struct.pack(">Q", n)
    return bytes(head) + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


async def ws_recv(reader, inflater):
    """-> (opcode, compressed, payload) of one unfragmented frame."""
    head = await reader.readexactly(2)
    rsv1 = bool(head[0] & 0x40)
    opcode = head[0] & 0x0F
    n = head[1] & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    payload = await reader.readexactly(n)
    if rsv1 and opcode in (1, 2):
        payload = inflater.decompress(payload + b"\x00\x00\xff\xff")
    return opcode, rsv1, payload


async def ws_connect(port: int, path: str, offer_deflate: bool = False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    ext = ("Sec-WebSocket-Extensions: permessage-deflate; "
           "client_no_context_takeover\r\n" if offer_deflate else "")
    writer.write(
        (f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
         f"Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
         f"{ext}Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    if b"101" not in head.split(b"\r\n")[0]:
        raise LiveDriveError(f"websocket upgrade refused: {head[:80]!r}")
    return reader, writer, b"permessage-deflate" in head


async def http_get(port: int, path: str) -> bytes:
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
            .encode())
    await w.drain()
    raw = await r.read()
    w.close()
    return raw


async def read_metrics(port: int) -> dict:
    """``/_metrics`` as {name: float} (labelled series keep their labels)."""
    raw = await http_get(port, "/_metrics")
    out = {}
    for line in raw.decode("latin-1", "replace").splitlines():
        if line.startswith("mixlab_"):
            name, _, value = line.rpartition(" ")
            try:
                out[name] = float(value)
            except ValueError:
                pass
    return out


async def _poll_metrics(port: int, readings: list) -> None:
    """Append (monotonic time, metrics) every half second until cancelled."""
    while True:
        readings.append((time.monotonic(), await read_metrics(port)))
        await asyncio.sleep(0.5)


def _tick_rate(first, last) -> float:
    (t0, m0), (t1, m1) = first, last
    return (m1.get("mixlab_engine_tick", 0.0)
            - m0.get("mixlab_engine_tick", 0.0)) / (t1 - t0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _find_socket_id(obj):
    if isinstance(obj, dict):
        if "socket_id" in obj:
            return obj["socket_id"]
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            r = _find_socket_id(v)
            if r:
                return r
    return None


async def _drive(proj_path: str, log_path: str, ops: List, *, segments: int,
                 metrics_seconds: float, metrics_timeout: float,
                 boot_timeout: float,
                 server_args: List[str], say: Callable[[str], None]) -> dict:
    from mixlab_tpu import protocol as p
    from mixlab_tpu.protocol import wire

    port = free_port()
    t_boot = time.monotonic()
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mixlab_tpu", "--listen",
             f"127.0.0.1:{port}", *server_args, proj_path],
            cwd=str(ROOT), stdout=logf, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONFAULTHANDLER": "1"})
    result = {}
    try:
        deadline = time.monotonic() + boot_timeout
        while True:
            if proc.poll() is not None:
                raise LiveDriveError(f"server died on startup (rc {proc.returncode})")
            if time.monotonic() > deadline:
                raise LiveDriveError("server never became ready")
            try:
                if b" 200 " in (await http_get(port, "/")).split(b"\r\n")[0]:
                    break
            except OSError:
                pass
            await asyncio.sleep(0.5)
        result["boot_s"] = time.monotonic() - t_boot
        say(f"server up after {result['boot_s']:.1f} s")

        inflater = zlib.decompressobj(wbits=-15)
        reader, writer, deflated = await ws_connect(port, "/session",
                                                    offer_deflate=True)
        _, rsv1, payload = await asyncio.wait_for(ws_recv(reader, inflater), 60)
        kind, _ = wire.parse_envelope(payload)
        if kind != "WorkspaceState" or not (deflated and rsv1):
            raise LiveDriveError("expected a compressed WorkspaceState first")

        # /_metrics from the first op to the end of the realtime window
        readings = [(time.monotonic(), await read_metrics(port))]
        poller = asyncio.create_task(_poll_metrics(port, readings))
        for seq, op in enumerate(ops, start=1):
            msg = p.WorkspaceMessage(seq, op)
            env = json.dumps({"v": 1, "kind": "Workspace", "m": wire.encode(msg)})
            writer.write(mask_frame(1, env.encode()))
        await writer.drain()
        say(f"sent {len(ops)} workspace ops")

        # session traffic until every op is echoed (Sync) and the monitor's
        # socket id has been announced
        socket_id, synced = None, 0
        deadline = time.monotonic() + 300
        while synced < len(ops) or socket_id is None:
            if time.monotonic() > deadline:
                raise LiveDriveError(f"{synced}/{len(ops)} ops synced, "
                                     f"monitor socket {socket_id}")
            _, _, payload = await asyncio.wait_for(ws_recv(reader, inflater), 120)
            kind, body = wire.parse_envelope(payload)
            socket_id = socket_id or _find_socket_id(body)
            synced += kind == "Sync"

        mr, mw, _ = await ws_connect(port, f"/_monitor/{socket_id}")
        minf = zlib.decompressobj(wbits=-15)
        _, _, payload = await asyncio.wait_for(ws_recv(mr, minf), 300)
        init = json.loads(payload.partition(b"\n")[0])
        if init.get("t") != "init" or init.get("mode") != "fmp4":
            raise LiveDriveError(f"monitor init is not fmp4: {init}")
        result["monitor_mime"] = init.get("mime")
        n_seg, t_seg = 0, time.monotonic()
        while n_seg < segments:
            _, _, payload = await asyncio.wait_for(ws_recv(mr, minf), 60)
            header, _, seg = payload.partition(b"\n")
            if json.loads(header).get("t") == "segment":
                if seg[4:8] != b"moof":
                    raise LiveDriveError("segment without a moof box")
                n_seg += 1
        result["segments"] = n_seg
        result["segments_s"] = time.monotonic() - t_seg
        say(f"{n_seg} fMP4 segments in {result['segments_s']:.1f} s "
            f"({result['monitor_mime']})")

        # realtime over a window: an unbroken run of realtime=1 readings
        # spanning ``metrics_seconds`` (edits sent above may still be
        # compiling and swapping in when it opens), within
        # ``metrics_timeout``.  The whole drive, from the first op to the
        # window's end, is reported beside it: its tick rate and how many
        # readings were realtime=0.
        t_give_up = time.monotonic() + metrics_timeout
        while True:
            run = []
            for r in reversed(readings):
                if r[1].get("mixlab_engine_realtime") != 1.0:
                    break
                run.insert(0, r)
            if run and run[-1][0] - run[0][0] >= metrics_seconds:
                break
            if time.monotonic() > t_give_up:
                rt = [m.get("mixlab_engine_realtime") for _, m in readings]
                raise LiveDriveError(f"no {metrics_seconds:.0f} s realtime "
                                     f"window in {metrics_timeout:.0f} s: {rt}")
            await asyncio.sleep(0.5)
        poller.cancel()  # no await since the window closed: run ends it
        drive = readings
        rt = [m.get("mixlab_engine_realtime") for _, m in drive]
        result["realtime_readings"] = rt
        result["realtime_zero_readings"] = sum(v == 0.0 for v in rt)
        result["drive_s"] = drive[-1][0] - drive[0][0]
        result["tick_rate_drive"] = _tick_rate(drive[0], drive[-1])
        result["window_s"] = run[-1][0] - run[0][0]
        result["tick_rate_window"] = _tick_rate(run[0], run[-1])
        faults = {k: run[-1][1].get(k) for k in FAULT_METRICS}
        result["faults"] = faults
        say(f"whole drive: {result['drive_s']:.1f} s from the first op at "
            f"{result['tick_rate_drive']:.1f} ticks/s, "
            f"{result['realtime_zero_readings']} of {len(rt)} readings "
            f"realtime=0; window after the edits swapped in: realtime=1 "
            f"over {result['window_s']:.1f} s at "
            f"{result['tick_rate_window']:.1f} ticks/s; faults {faults}")
        if any(v is None or v != 0.0 for v in faults.values()):
            raise LiveDriveError(f"device block faults: {faults}")
        mw.close()
        writer.close()

        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)
            proc.wait(timeout=10)
            raise LiveDriveError("server hung on SIGTERM")
        if rc != 0:
            raise LiveDriveError(f"server exit code {rc}")
        say("server exited 0 on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

    conn = sqlite3.connect(proj_path)
    try:
        saved = json.loads(
            conn.execute("SELECT serialized FROM workspace").fetchone()[0])
    finally:
        conn.close()
    result["persisted"] = saved
    return result


def drive_live(proj_path: str, log_path: str, ops: List, *, segments: int = 20,
               metrics_seconds: float = 6.0, metrics_timeout: float = 60.0,
               boot_timeout: float = 600.0,
               server_args: Optional[List[str]] = None,
               say: Callable[[str], None] = print) -> dict:
    """Run one live session against a new server process; raises
    :class:`LiveDriveError` on any failure.  Returns what was observed,
    with the persisted workspace under ``"persisted"``."""
    return asyncio.run(_drive(
        proj_path, log_path, ops, segments=segments,
        metrics_seconds=metrics_seconds, metrics_timeout=metrics_timeout,
        boot_timeout=boot_timeout,
        server_args=list(server_args or []), say=say))


def workspace_ops(ws) -> List:
    """CreateModule ops (in module-id order, so a fresh server assigns the
    same ids) and CreateConnection ops that rebuild ``ws`` over the wire."""
    from mixlab_tpu import protocol as p

    ops = [p.CreateModule(ws.modules[mid].params, p.WindowGeometry())
           for mid in sorted(ws.modules, key=lambda m: m.value)]
    ops += [p.CreateConnection(i, o) for i, o in ws.connections.items()]
    return ops
