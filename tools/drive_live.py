"""Live-drive verification: a real server subprocess on the device.

Usage: python tools/drive_live.py [--segments 40]

Boots `python -m mixlab_tpu --listen` on a fresh project, speaks raw
RFC-6455 with a permessage-deflate offer, creates Oscillator -> Monitor
over the wire, streams real fMP4 segments from /_monitor, checks /_metrics
realtime=1 and zero device block faults, SIGTERMs expecting exit 0 with
the edits persisted (mixlab_tpu/server/live_client.py does the driving).
"""
import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mixlab_tpu import protocol as p  # noqa: E402
from mixlab_tpu.server.live_client import drive_live  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", type=int, default=40)
    args = ap.parse_args()
    ops = [
        p.CreateModule(p.ModuleParams(
            "Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry()),
        p.CreateModule(p.ModuleParams("Monitor", None), p.WindowGeometry()),
        p.CreateConnection(p.InputId(p.ModuleId(2), 1),
                           p.OutputId(p.ModuleId(1), 1)),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        out = drive_live(str(pathlib.Path(tmp) / "drive.mixlab"),
                         str(pathlib.Path(tmp) / "server.log"), ops,
                         segments=args.segments)
    kinds = sorted(json.dumps(m.get("params"))
                   for m in out["persisted"].get("modules", {}).values())
    assert any("Oscillator" in k for k in kinds), kinds
    assert any("Monitor" in k for k in kinds), kinds
    print("LIVE DRIVE: ALL OK")


if __name__ == "__main__":
    main()
