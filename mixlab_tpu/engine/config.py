"""Engine configuration.

The reference hard-codes 44.1 kHz / 60 ticks/s / 735 samples per tick
(``src/engine.rs:52-55``).  This build makes the sample rate a runtime
parameter (44_100 for parity against reference goldens, 48_000 for the
benchmark configs — see BASELINE.md discrepancy note) and adds a block size:
the number of ticks rendered per device dispatch.  Realtime serving uses
small blocks; offline render/bench uses large blocks to amortize dispatch
and host<->device transfer.
"""

from __future__ import annotations

from dataclasses import dataclass

CHANNELS = 2  # src/engine.rs:52
TICKS_PER_SECOND = 60  # src/engine.rs:54


@dataclass(frozen=True)
class EngineConfig:
    sample_rate: int = 44_100
    ticks_per_second: int = TICKS_PER_SECOND
    channels: int = CHANNELS
    # dtype for on-device DSP math. The reference computes in f64 and stores
    # f32; accelerators have no fast f64, so device math is f32 with per-kernel
    # precision workarounds (see dsp/audio.py oscillator phase handling).
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.sample_rate % self.ticks_per_second != 0:
            raise ValueError(
                f"sample_rate {self.sample_rate} not divisible by "
                f"ticks_per_second {self.ticks_per_second}"
            )

    @property
    def samples_per_tick(self) -> int:
        return self.sample_rate // self.ticks_per_second

    @property
    def tick_budget_us(self) -> int:
        # src/engine/timing.rs:9
        return 1_000_000 // self.ticks_per_second


@dataclass(frozen=True)
class BlockSpec:
    """Static shape of one device dispatch: ``n_ticks`` engine ticks."""

    n_ticks: int = 1

    def n_samples(self, cfg: EngineConfig) -> int:
        return self.n_ticks * cfg.samples_per_tick


DEFAULT_CONFIG = EngineConfig()
