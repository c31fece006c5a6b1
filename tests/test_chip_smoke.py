"""Rehearsal of chip_smoke.py on the CPU: every phase at a tiny size, the
Pallas kernel in interpret mode, and the device check refusing the CPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from piet_tpu import gpu
from piet_tpu.gpu import require_gpu
from piet_tpu.scene.svg import make_tiger


@pytest.fixture
def short_warmup(monkeypatch):
    """Two warm-up samples: CPU samples of tiny scenes need not agree."""
    monkeypatch.setattr(gpu, "WARMUP_S", 0.0)
    monkeypatch.setattr(gpu, "WARMUP_MAX_S", 0.0)


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="GPU"):
        require_gpu([])
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main([])


def test_script_fails_without_gpu():
    """Run as a script on a CPU-only host: non-zero exit, no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(chip_smoke.__file__))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_kernel_tiny():
    out = chip_smoke.phase_kernel(make_tiger(scale=1.2), 256, 256,
                                  interpret=True)
    for impl in ("pallas", "xla"):
        assert out[impl]["compile_s"] > 0
        assert out[impl]["max_tile_cmds"] > 0
    for k in ("kernel_vs_xla", "kernel_vs_golden", "xla_vs_golden"):
        assert out[k]["max_codes"] <= 2
    json.dumps(out)


def test_phase_coarse_tiny():
    from tests.test_coarse import CASES
    out = chip_smoke.phase_coarse(CASES[:1], jit=False)
    assert out == {"exact": [CASES[0][0]]}


def test_phase_main_path_tiny():
    from piet_tpu.scene.fixtures import make_animated_frame
    from tests.test_group_clips import _clip_scene
    big = [("tiger", make_tiger(scale=1.2), 256, 256)]
    small = [("clip_layer", _clip_scene(), 256, 256)]
    seq = ([make_animated_frame(t / 4.0, size=128, n=12) for t in range(2)],
           128, 128)
    out = chip_smoke.phase_main_path(big, small, seq, interpret=True)
    assert set(out) == {"tiger", "clip_layer", "render_sequence"}
    assert out["render_sequence"]["frames"] == 2
    assert out["tiger"]["max_tile_cmds"] <= out["tiger"][
        "dense_cmd_capacity"]


def test_phase_timing_tiny(short_warmup):
    out = chip_smoke.phase_timing(
        [("tiger", make_tiger(scale=0.3), 128, 64)], interpret=True,
        runs=((1, 2), (1, 1)))
    row = out["tiger"]
    for label in ("kernel", "xla"):
        t = row[label]
        assert 0 < t["min_ms"] <= t["median_ms"] <= t["max_ms"]
        assert t["warmup_samples"] == 2 and t["max_tile_cmds"] > 0


class _Clock:
    """A fake ``time`` whose clock only the timed function advances."""

    def __init__(self, step_ms):
        self.now, self.steps = 0.0, iter(step_ms)

    def perf_counter(self):
        return self.now

    def run(self, _):
        self.now += next(self.steps) / 1e3


def test_time_frames_warms_up_until_samples_agree(monkeypatch):
    """Slow first samples (clocks ramping) stay out of the measurement:
    warm-up runs for WARMUP_S and until two samples agree."""
    monkeypatch.setattr(gpu, "WARMUP_S", 0.05)
    # One compile call, then 1-frame samples: 30, 20, 12, 10, 10 ms of
    # warm-up (the last two agree, 0.082 s > WARMUP_S), then 3 samples.
    clock = _Clock([500, 30, 20, 12, 10, 10, 10, 11, 9])
    monkeypatch.setattr(gpu, "time", clock)
    t = gpu.time_frames(clock.run, None, 1, 3)
    assert t["warmup_samples"] == 5
    assert t["median_ms"] == pytest.approx(10.0)
    assert t["min_ms"] == pytest.approx(9.0)
    assert t["max_ms"] == pytest.approx(11.0)


def test_time_frames_warmup_is_bounded(monkeypatch):
    """Samples that never agree end the warm-up at WARMUP_MAX_S."""
    monkeypatch.setattr(gpu, "WARMUP_MAX_S", 0.095)
    clock = _Clock([0] + [10, 20] * 50)
    monkeypatch.setattr(gpu, "time", clock)
    t = gpu.time_frames(clock.run, None, 1, 2)
    assert t["warmup_samples"] == 7
    assert t["min_ms"] == pytest.approx(10.0)
    assert t["max_ms"] == pytest.approx(20.0)


def test_no_phase_selection_option():
    """The one-card run always runs every phase: the contract line means
    all of them passed, so there is no option to pick phases."""
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "timing"])


def test_phase_sharded_tiny():
    """Four virtual CPU devices: shards on four devices, bitwise equal to
    the one-device renderer."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    out = chip_smoke.phase_sharded(make_tiger(scale=0.6), 256, 128 * 2,
                                   devices, interpret=True)
    assert len(out["shard_devices"]) == 4
    assert out["bitwise_vs_one_device"]
    assert np.isfinite(out["vs_golden"]["pixel_frac"])
