"""Fleet controller (server/fleet.py): spawn / route / migrate / recover
with REAL worker processes over real sockets.

Covers the scale-out story end to end: two host agents register with a
controller; workspaces are placed least-loaded; a live workspace (with an
edit and runtime DSP state) migrates between hosts carrying both the
project file and the engine checkpoint; a crashed worker is respawned on
route resolution."""

import asyncio
import json

import numpy as np
import pytest

from mixlab_tpu.server.fleet import (
    FleetController,
    HostAgent,
    decode_checkpoint,
    encode_checkpoint,
    http_call,
)


def test_checkpoint_blob_roundtrip():
    ckpt = {
        "tick": 1234,
        "dsp_state": [np.arange(8, dtype=np.float32),
                      np.ones((2, 3), dtype=np.int32)],
    }
    blob = encode_checkpoint(ckpt)
    back = decode_checkpoint(blob)
    assert back["tick"] == 1234
    assert len(back["dsp_state"]) == 2
    assert np.array_equal(back["dsp_state"][0], ckpt["dsp_state"][0])
    assert np.array_equal(back["dsp_state"][1], ckpt["dsp_state"][1])


def test_fleet_spawn_route_migrate_recover(tmp_path):
    from mixlab_tpu import protocol as p
    from mixlab_tpu.protocol import wire
    from test_server import mask_frame, ws_connect, ws_recv

    async def go():
        ctl = FleetController()
        ctl_server = await ctl.serve()
        agents = []
        servers = [ctl_server]
        for host_id in ("host-a", "host-b"):
            agent = HostAgent(host_id, tmp_path / host_id)
            servers.append(await agent.serve())
            agents.append(agent)
            await http_call(ctl.url + "/register", "POST", json.dumps(
                {"host_id": host_id, "url": agent.url}).encode())

        # periodic heartbeats, as real agents send (fleet.py run_agent) —
        # worker spawns can take longer than the liveness TTL
        async def beat():
            while True:
                for a in agents:
                    await http_call(ctl.url + "/heartbeat", "POST",
                                    json.dumps({"host_id": a.host_id}).encode())
                await asyncio.sleep(1.0)

        hb = asyncio.ensure_future(beat())

        # ---- placement balances load across live agents ----
        status, body = await http_call(ctl.url + "/workspaces/alpha", "POST",
                                       timeout=90.0)
        assert status == 200, body
        alpha = json.loads(body)
        status, body = await http_call(ctl.url + "/workspaces/beta", "POST",
                                       timeout=90.0)
        assert status == 200, body
        beta = json.loads(body)
        assert {alpha["host"], beta["host"]} == {"host-a", "host-b"}

        status, body = await http_call(ctl.url + "/fleet")
        fleet = json.loads(body)
        assert fleet["assignments"] == {"alpha": alpha["host"],
                                        "beta": beta["host"]}
        assert all(a["live"] for a in fleet["agents"].values())

        # ---- routing resolves to a serving worker ----
        status, body = await http_call(ctl.url + "/route/alpha")
        assert status == 200
        route = json.loads(body)
        status, page = await http_call(route["url"] + "/")
        assert status == 200 and b"mixlab" in page
        status, _ = await http_call(ctl.url + "/route/nope")
        assert status == 404

        # ---- drive a session on alpha: create an oscillator ----
        port = int(route["url"].rsplit(":", 1)[1])
        reader, writer = await ws_connect("127.0.0.1", port, "/session")
        await asyncio.wait_for(ws_recv(reader), 60)  # WorkspaceState
        await asyncio.wait_for(ws_recv(reader), 60)  # MediaLibrary
        msg = p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator",
                           p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry()))
        env = json.dumps({"v": 1, "kind": "Workspace", "m": wire.encode(msg)})
        writer.write(mask_frame(1, env.encode()))
        await writer.drain()
        # wait for the Sync echo so the edit is persisted
        for _ in range(6):
            _, payload = await asyncio.wait_for(ws_recv(reader), 60)
            kind, body_ = wire.parse_envelope(payload)
            if kind == "Sync":
                break
        writer.close()
        # let the engine tick so the checkpoint has a non-zero tick and
        # the async compile adopts the oscillator patch
        await asyncio.sleep(2.0)

        # the worker exposes a live checkpoint
        status, ckpt_blob = await http_call(route["url"] + "/_checkpoint")
        assert status == 200
        ckpt = decode_checkpoint(ckpt_blob)
        assert ckpt["tick"] > 0

        # ---- live migration to the other host ----
        other = "host-b" if alpha["host"] == "host-a" else "host-a"
        status, body = await http_call(
            ctl.url + "/migrate/alpha", "POST",
            json.dumps({"to": other}).encode(), timeout=90.0)
        assert status == 200, body
        moved = json.loads(body)
        assert moved["host"] == other
        # the runtime DSP state traveled too: the target engine adopted the
        # checkpoint (resumes from the same tick, not from zero)
        assert moved.get("restored") is True
        status, ck2 = await http_call(moved["url"] + "/_checkpoint")
        assert status == 200
        assert decode_checkpoint(ck2)["tick"] >= ckpt["tick"]

        status, body = await http_call(ctl.url + "/route/alpha")
        route2 = json.loads(body)
        assert route2["host"] == other and route2["url"] != route["url"]

        # the migrated worker carries the workspace: oscillator is there
        port2 = int(route2["url"].rsplit(":", 1)[1])
        reader, writer = await ws_connect("127.0.0.1", port2, "/session")
        _, payload = await asyncio.wait_for(ws_recv(reader), 60)
        kind, state = wire.parse_envelope(payload)
        assert kind == "WorkspaceState"
        kinds = [params["kind"] for _, params in state["modules"]]
        assert "Oscillator" in kinds
        writer.close()

        # ---- failure recovery: kill beta's worker, route respawns it ----
        beta_agent = next(a for a in agents if a.host_id == beta["host"])
        beta_proc = beta_agent.procs["beta"]["proc"]
        beta_proc.kill()
        beta_proc.wait(10)
        status, body = await http_call(ctl.url + "/route/beta", timeout=90.0)
        assert status == 200
        recovered = json.loads(body)
        assert recovered.get("respawned")
        status, page = await http_call(recovered["url"] + "/")
        assert status == 200

        # ---- teardown ----
        hb.cancel()
        for agent in agents:
            await agent.shutdown()
        for server in servers:
            server.close()

    asyncio.run(asyncio.wait_for(go(), 420))


def test_agent_watchdog_respawns_crashed_worker(tmp_path):
    """With a respawn interval set, a crashed worker comes back without any
    route request (agent-side failure recovery)."""

    async def go():
        agent = HostAgent("wd", tmp_path / "wd", respawn_interval=0.3)
        server = await agent.serve()
        await agent.spawn("w")
        proc = agent.procs["w"]["proc"]
        proc.kill()
        proc.wait(10)
        deadline = asyncio.get_event_loop().time() + 90
        while asyncio.get_event_loop().time() < deadline:
            h = agent.health()
            info = h["workspaces"].get("w")
            if info and info["alive"] and agent.procs["w"]["proc"] is not proc:
                break
            await asyncio.sleep(0.25)
        else:
            raise AssertionError("watchdog never respawned the worker")
        status, _ = await http_call(agent.procs["w"]["url"] + "/")
        assert status == 200
        await agent.shutdown()
        server.close()

    asyncio.run(asyncio.wait_for(go(), 180))


def test_agent_rejects_path_traversal_keys(tmp_path):
    async def go():
        agent = HostAgent("sec", tmp_path / "sec")
        server = await agent.serve()
        for bad in ("../../etc/pwn", "a/b", "", ".hidden", "x" * 200):
            try:
                status, _ = await http_call(
                    agent.url + f"/spawn/{bad}", "POST", timeout=10.0)
            except Exception:
                continue  # unroutable path forms are fine too
            assert status in (400, 404), (bad, status)
        # nothing was spawned, nothing written outside data_dir
        assert agent.procs == {}
        await agent.shutdown()
        server.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_agent_gives_each_worker_its_own_card(tmp_path, monkeypatch):
    """On a GPU host every worker sees one card of its own
    (CUDA_VISIBLE_DEVICES), and the agent starts no more workers than the
    host has cards; a stopped worker's card is handed out again.  On the
    CPU (tests) the card list is None and nothing changes."""
    from mixlab_tpu.server import fleet

    assert fleet.host_cards() is None  # conftest runs JAX on the CPU
    assert HostAgent("cpu", tmp_path / "cpu").cards is None
    started = []

    class FakeProc:
        pid = 1
        returncode = None

        def __init__(self, argv, env=None, **kw):
            self.env = env
            self.alive = True
            started.append(self)

        def poll(self):
            return None if self.alive else 0

        def terminate(self):
            self.alive = False

        def wait(self, timeout=None):
            return 0

    async def ok_http(url, *a, **kw):
        return 200, b"ok"

    monkeypatch.setattr(fleet.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(fleet, "http_call", ok_http)

    async def go():
        agent = HostAgent("gpu", tmp_path / "gpu", cards=["0", "1"])
        await agent.spawn("a")
        await agent.spawn("b")
        assert [p.env["CUDA_VISIBLE_DEVICES"] for p in started] == ["0", "1"]
        with pytest.raises(RuntimeError, match="cards"):
            await agent.spawn("c")
        assert len(started) == 2  # refused before starting a process
        await agent.stop("a")
        await agent.spawn("c")
        assert started[-1].env["CUDA_VISIBLE_DEVICES"] == "0"

    asyncio.run(asyncio.wait_for(go(), 30))


def test_fleet_auth_rejects_unauthenticated(tmp_path):
    """With a shared secret configured, every agent/controller admin route
    rejects requests without the bearer token (constant-time compare)."""
    from mixlab_tpu.server.fleet import check_token

    async def go():
        ctl = FleetController(token="s3cret")
        ctl_server = await ctl.serve()
        agent = HostAgent("host-x", tmp_path / "x", token="s3cret")
        agent_server = await agent.serve()
        try:
            # no token -> 401 everywhere
            for url, method, body in [
                (ctl.url + "/fleet", "GET", b""),
                (ctl.url + "/register", "POST", b"{}"),
                (ctl.url + "/workspaces/w1", "POST", b""),
                (agent.url + "/health", "GET", b""),
                (agent.url + "/spawn/w1", "POST", b""),
                (agent.url + "/export/w1", "GET", b""),
            ]:
                status, _ = await http_call(url, method, body)
                assert status == 401, url
            # wrong token -> 401
            status, _ = await http_call(agent.url + "/health",
                                        token="wrong")
            assert status == 401
            # right token -> 200
            status, body = await http_call(agent.url + "/health",
                                           token="s3cret")
            assert status == 200
            assert json.loads(body)["host_id"] == "host-x"
            status, _ = await http_call(
                ctl.url + "/register", "POST",
                json.dumps({"host_id": "host-x",
                            "url": agent.url}).encode(),
                token="s3cret")
            assert status == 200
        finally:
            ctl_server.close()
            agent_server.close()
            await agent.shutdown()

    asyncio.run(go())


def test_fleet_body_caps(tmp_path):
    """Oversized control bodies are rejected with 413, not buffered."""

    async def go():
        ctl = FleetController()
        ctl_server = await ctl.serve()
        try:
            big = b"x" * (2 << 20)  # 2 MiB > MAX_JSON_BODY
            status, _ = await http_call(ctl.url + "/register", "POST", big)
            assert status == 413
        finally:
            ctl_server.close()

    asyncio.run(go())


def test_concurrent_place_single_assignment(tmp_path, monkeypatch):
    """Two concurrent placements of the same key must resolve to ONE
    assignment and ONE spawn (the round-2 advisor race)."""

    async def go():
        ctl = FleetController()
        spawns = []

        async def fake_health(host_id):
            await asyncio.sleep(0.05)  # widen the race window
            return {"load": 0, "workspaces": {
                k: {"url": "http://x", "alive": True}
                for k in ctl.assignments}}

        async def fake_spawn(host_id, key):
            await asyncio.sleep(0.05)
            spawns.append((host_id, key))
            return {"url": "http://x"}

        ctl._agent_health = fake_health
        ctl._spawn_on = fake_spawn
        ctl.register("host-a", "http://a")
        r1, r2 = await asyncio.gather(ctl.place("w1"), ctl.place("w1"))
        assert spawns == [("host-a", "w1")]
        assert ctl.assignments == {"w1": "host-a"}
        assert r1["host"] == r2["host"] == "host-a"

    asyncio.run(go())


def test_place_prefers_fewer_sessions_over_workspace_count(monkeypatch):
    """Placement weighs connected sessions ahead of raw workspace count:
    an agent running MORE workspaces but serving FEWER live sessions wins
    (ROADMAP "Scale-out": session-count-aware policy)."""

    async def go():
        ctl = FleetController()
        health = {
            # host-a: one workspace, but 7 connected sessions
            "host-a": {"load": 1, "sessions": 7, "workspaces": {}},
            # host-b: three workspaces, all idle
            "host-b": {"load": 3, "sessions": 0, "workspaces": {}},
        }
        spawns = []

        async def fake_health(host_id):
            return health[host_id]

        async def fake_spawn(host_id, key):
            spawns.append(host_id)
            return {"url": "http://x"}

        ctl._agent_health = fake_health
        ctl._spawn_on = fake_spawn
        ctl.register("host-a", "http://a")
        ctl.register("host-b", "http://b")
        await ctl.place("w1")
        assert spawns == ["host-b"]
        # an agent whose health omits sessions (older agent) still places:
        # missing count treated as 0, tiebreak falls to workspace count
        health["host-a"] = {"load": 0, "workspaces": {}}
        await ctl.place("w2")
        assert spawns == ["host-b", "host-a"]

    asyncio.run(go())


def test_agent_health_full_scrapes_worker_sessions(tmp_path):
    """health_full sums mixlab_sessions_connected scraped from each live
    worker's /_metrics (unreachable workers count 0, never fail health)."""

    async def go():
        agent = HostAgent("h", tmp_path)

        async def serve_metrics(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            body = b"mixlab_engine_tick 5\nmixlab_sessions_connected 3\n"
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s"
                % (len(body), body))
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(serve_metrics, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]

        class FakeProc:
            def poll(self):
                return None

        agent.procs["w1"] = {"proc": FakeProc(), "port": port,
                             "url": f"http://127.0.0.1:{port}"}
        agent.procs["w2"] = {"proc": FakeProc(), "port": 1,
                             "url": "http://127.0.0.1:1"}  # unreachable
        h = await agent.health_full()
        assert h["sessions"] == 3
        assert h["workspaces"]["w1"]["sessions"] == 3
        assert h["workspaces"]["w2"]["sessions"] == 0
        srv.close()
        await srv.wait_closed()

    asyncio.run(go())


def _make_cert(tmp_path, name):
    """Self-signed cert+key with a 127.0.0.1 SAN via the openssl CLI."""
    import shutil
    import subprocess

    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    cert = tmp_path / f"{name}.crt"
    key = tmp_path / f"{name}.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=mixlab-fleet",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=120)
    return str(cert), str(key)


def test_fleet_tls_pinned_control_plane(tmp_path):
    """TLS on the fleet control plane (ROADMAP "Scale-out"): controller and
    agent serve https with a fleet cert; clients verify against the pinned
    CA.  Plain HTTP and wrong-CA clients are rejected at the channel layer;
    the pinned client with the bearer token drives registration, placement,
    and worker spawn end to end."""
    import ssl

    from mixlab_tpu.server.fleet import FleetTls

    cert, key = _make_cert(tmp_path, "fleet")
    other_cert, other_key = _make_cert(tmp_path, "other")
    tls = FleetTls(cert, key)

    async def go():
        ctl = FleetController(token="s3cret", tls=tls)
        ctl_server = await ctl.serve()
        agent = HostAgent("host-t", tmp_path / "t", token="s3cret", tls=tls)
        agent_server = await agent.serve()
        assert ctl.url.startswith("https://")
        assert agent.url.startswith("https://")
        ctx = tls.client_ctx()
        try:
            # plain-HTTP client against the TLS port fails at the channel
            with pytest.raises((ssl.SSLError, ConnectionError,
                                asyncio.IncompleteReadError,
                                asyncio.TimeoutError)):
                await http_call("http" + ctl.url[len("https"):] + "/fleet",
                                token="s3cret", timeout=3.0)
            # a client pinning a DIFFERENT CA refuses the server cert
            wrong = FleetTls(other_cert, other_key).client_ctx()
            with pytest.raises(ssl.SSLError):
                await http_call(ctl.url + "/fleet", token="s3cret",
                                ssl_ctx=wrong, timeout=3.0)
            # mTLS: a client with NO fleet cert is refused by the server
            anon = ssl.create_default_context(cafile=cert)
            anon.check_hostname = False
            with pytest.raises((ssl.SSLError, ConnectionError,
                                asyncio.IncompleteReadError,
                                asyncio.TimeoutError)):
                await http_call(ctl.url + "/fleet", token="s3cret",
                                ssl_ctx=anon, timeout=3.0)
            # pinned client + token: register, then place a workspace
            status, _ = await http_call(
                ctl.url + "/register", "POST",
                json.dumps({"host_id": "host-t",
                            "url": agent.url}).encode(),
                token="s3cret", ssl_ctx=ctx)
            assert status == 200
            # TLS alone is not enough: the bearer token is still enforced
            status, _ = await http_call(ctl.url + "/fleet", ssl_ctx=ctx)
            assert status == 401
            status, body = await http_call(
                ctl.url + "/workspaces/wtls", "POST",
                token="s3cret", ssl_ctx=ctx, timeout=330.0)
            assert status == 200
            placed = json.loads(body)
            assert placed["host"] == "host-t"
            # the worker itself is loopback http behind the agent
            assert placed["url"].startswith("http://")
            status, body = await http_call(placed["url"] + "/_metrics",
                                           timeout=10.0)
            assert status == 200
        finally:
            ctl_server.close()
            agent_server.close()
            await agent.shutdown()

    asyncio.run(go())
