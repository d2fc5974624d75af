"""chip_smoke.py measures only on a GPU: elsewhere, and outside a checkout,
it exits non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(cwd, args=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [(), ("--multi",)])
def test_refuses_without_gpu(args):
    out = run(ROOT, args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
