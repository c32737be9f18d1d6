"""chip_smoke.py refuses to run without a GPU and prints no result."""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out):
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_on_cpu():
    out = _run(ROOT)
    _no_result(out)
    assert "not a GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _no_result(_run(tmp_path))
