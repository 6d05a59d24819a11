"""The bench.py contract: exactly one JSON line with the required keys
when it runs, and a failure — no line — when no GPU is present and the
CPU was not asked for."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    POLLEN_BENCH_STEPS=str(2**14),
    POLLEN_BENCH_SEGS=str(2**10),
    POLLEN_BENCH_PATHS="16",
    POLLEN_BENCH_REPS="5",
)


def _run_bench(extra_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **SMALL)
    env.pop("POLLEN_BENCH_PLATFORM", None)
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
        cwd=REPO,
    )


def test_bench_fails_without_gpu():
    """No GPU and no explicit CPU request: non-zero exit, no JSON line
    (a CPU number is never reported as a device number)."""
    proc = _run_bench({})
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "no GPU" in proc.stderr


def test_bench_emits_one_json_line():
    proc = _run_bench({"POLLEN_BENCH_PLATFORM": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    json_lines = [
        ln for ln in proc.stdout.splitlines() if ln.startswith("{")
    ]
    assert len(json_lines) == 1, proc.stdout
    rec = json.loads(json_lines[0])
    assert rec["metric"] == "masked_depth_steps_per_s"
    assert rec["unit"] == "steps/s"
    assert rec["value"] > 0
    assert 0 <= rec["vs_baseline"]
    assert "# device cpu" in proc.stderr
