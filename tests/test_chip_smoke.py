"""chip_smoke.py refuses to pass without a GPU: there is no CPU fallback."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_device_phase_fails_on_a_cpu_backend(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(chip_smoke.PhaseFailed, match="no GPU"):
        chip_smoke.phase_device(1)


def test_smoke_exits_nonzero_without_a_result_on_cpu(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(tmp_path))
    assert out.returncode != 0
    # the device phase decides it, before anything else touches the card
    assert "no GPU" in out.stderr, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    assert all(not line.startswith("{") or not json.loads(line).get("ok")
               for line in lines)
