"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The script itself refuses to run without a GPU; its phase functions take
their sizes as arguments, so the same code paths and checks run here."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]


def _ok(line):
    assert line["ok"], line["checks"]
    return line


def test_phase_scene_tiny():
    line = _ok(chip_smoke.phase_scene(lanes=8192, path=10, reps=1))
    assert line["dot_generals"] == line["dot_generals_highest"] > 0


def test_phase_array_tiny():
    line = _ok(chip_smoke.phase_array(lanes=1024, path=3, reps=1))
    assert line["modules"] == 125


def test_phase_volume_tiny():
    _ok(chip_smoke.phase_volume(lanes=16384, reps=1))


def test_phase_gradient_tiny():
    line = _ok(chip_smoke.phase_gradient(lanes=2048, path=4, reps=1))
    assert line["grad_sum"] < 0


def test_phase_conformance_tiny():
    line = _ok(chip_smoke.phase_conformance(["c1_volume_homogeneous"]))
    assert line["max_rel_diff"]["c1_volume_homogeneous.hist"] <= 1e-6


def test_four_card_checks_tiny():
    lines = chip_smoke.four_card_checks(
        jax.devices()[:4], lanes_per_card=256, path=3, reps=1
    )
    assert [l["phase"] for l in lines] == [
        "four_shard_trace", "four_psum_gradient", "four_instanced_ladder"
    ]
    for line in lines:
        _ok(line)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_fails_without_gpu(argv):
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), *argv],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
