"""Rules of the PyTorch port: it never imports JAX or the JAX package, and
its entry points default to the card, raising where there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.ops import build
from tpu_parallel_torch.runtime import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpu_parallel"}
PORT_FILES = sorted((REPO / "tpu_parallel_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_import_pulls_in_no_jax():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import tpu_parallel_torch, tpu_parallel_torch.models.generate, "
        "tpu_parallel_torch.models.convert, tpu_parallel_torch.core.losses, "
        "tpu_parallel_torch.utils.profiling, tpu_parallel_torch.train_lib, "
        "tpu_parallel_torch.core.accumulate, tpu_parallel_torch.core.optim, "
        "tpu_parallel_torch.core.metrics, tpu_parallel_torch.core.state, "
        "tpu_parallel_torch.data.synthetic\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        f"print(sorted(new & {FORBIDDEN!r}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_default_to_cuda():
    """Without a GPU the default device raises; with one it is used."""
    if torch.cuda.is_available():
        assert GPTLM(tiny_test()).device.type == "cuda"
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            GPTLM(tiny_test())
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    assert GPTLM(tiny_test(), device="cpu").device.type == "cpu"


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A source that cannot build raises; no wrapper falls back.  Without
    nvcc the error names the missing compiler, with it the compile error."""
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc|build failed"):
        build.load_library("broken")
    assert not list(tmp_path.rglob("*.so"))
