"""Fleet scale-out demo: controller + two host agents on this machine,
three workspaces placed least-loaded, one live-migrated between hosts.

    python examples/fleet_demo.py

Every worker is a real ``python -m mixlab_tpu`` server process; migration
moves the project file AND the engine's runtime DSP checkpoint, so the
target resumes from the same tick.

Each worker on a GPU host takes a card of its own (a JAX process reserves
most of a card's memory), and the two agents here split this machine's
cards between them.  The demo needs four workers at once (three placed,
one migration target), so on a machine with fewer cards, such as one H100,
run the workers on the CPU:

    JAX_PLATFORMS=cpu python examples/fleet_demo.py
"""

from __future__ import annotations

import asyncio
import json
import sys

import pathlib

# runnable as a script from anywhere: put the repo root on the path
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import tempfile
from pathlib import Path


async def main():
    from mixlab_tpu.server.fleet import (FleetController, HostAgent,
                                         host_cards, http_call)

    cards = host_cards()
    if cards is not None and len(cards) < 4:
        raise SystemExit(f"{len(cards)} card(s) here, the demo needs 4 "
                         "workers: run it with JAX_PLATFORMS=cpu")
    data = Path(tempfile.mkdtemp(prefix="fleet-demo-"))
    ctl = FleetController()
    await ctl.serve()
    agents = []
    for i, host_id in enumerate(("host-a", "host-b")):
        agent = HostAgent(host_id, data / host_id, respawn_interval=5.0,
                          cards=None if cards is None else cards[i::2])
        await agent.serve()
        agents.append(agent)
        await http_call(ctl.url + "/register", "POST", json.dumps(
            {"host_id": host_id, "url": agent.url}).encode())
    print(f"controller {ctl.url}; agents "
          + ", ".join(f"{a.host_id}={a.url}" for a in agents))

    async def beat():
        while True:
            for a in agents:
                await http_call(ctl.url + "/heartbeat", "POST", json.dumps(
                    {"host_id": a.host_id}).encode())
            await asyncio.sleep(1.0)

    hb = asyncio.ensure_future(beat())

    for key in ("drums", "vocals", "master"):
        _, body = await http_call(ctl.url + f"/workspaces/{key}", "POST",
                                  timeout=360.0)
        placed = json.loads(body)
        print(f"placed {key!r} on {placed['host']} -> {placed['url']}")

    _, body = await http_call(ctl.url + "/fleet")
    print("fleet:", json.dumps(json.loads(body), indent=2))

    _, body = await http_call(ctl.url + "/route/drums")
    src = json.loads(body)
    dst = "host-b" if src["host"] == "host-a" else "host-a"
    print(f"migrating 'drums' {src['host']} -> {dst} ...")
    _, body = await http_call(ctl.url + "/migrate/drums", "POST",
                              json.dumps({"to": dst}).encode(), timeout=360.0)
    moved = json.loads(body)
    print(f"migrated: now on {moved['host']} at {moved['url']} "
          f"(runtime state restored: {moved.get('restored')})")

    hb.cancel()
    for agent in agents:
        await agent.shutdown()
    print("done")


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
