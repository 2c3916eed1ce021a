"""chip_smoke.py refuses to run without a GPU or without the repo."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU backend (in the checkout, or copied alone into an empty
    directory) the script exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script), "--out",
                        str(tmp_path / "out")], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
