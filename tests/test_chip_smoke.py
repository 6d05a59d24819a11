"""chip_smoke.py: refuses to run without a GPU, and its checking
phases (golden fixtures, every masked-depth route against the NumPy
reference, the served path parsed back) pass at small shapes on the
CPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_phases_small(monkeypatch, capsys):
    import chip_smoke

    assert chip_smoke.phase_fixtures() == 32
    warm = chip_smoke.phase_routes(shape=(2**14, 2**10, 128), warm=3)
    assert "ell parts" in warm and "cross batch Q=32" in warm
    monkeypatch.setattr(chip_smoke, "CHR8_SEGS", 2**11)
    chip_smoke.phase_served(2**15)
    out = capsys.readouterr().out
    assert "all 8 served depth tables equal the NumPy reference" in out
