"""Rules of the PyTorch port: it never imports JAX, the JAX package,
``ml_dtypes``, orbax, ``ml_collections`` or absl (the card's machine has
none of them), nor does the worker its multi-rank tests run in; and its
entry points default to the card, raising where there is none."""

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
from tpu_parallel_torch.serving import ServingEngine

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpu_parallel", "ml_dtypes", "orbax",
             "ml_collections", "absl"}
PORT_FILES = sorted((REPO / "tpu_parallel_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_dp_worker.py"]


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


def test_scan_covers_every_subpackage():
    """Every package directory of the port (``daemon/`` included) has its
    modules in the scan above."""
    packages = {p.parent for p in (REPO / "tpu_parallel_torch").rglob("__init__.py")}
    scanned = {p.parent for p in PORT_FILES}
    assert REPO / "tpu_parallel_torch" / "daemon" in packages
    for sub in ("checkpoint", "configs", "data", "runtime", "parallel"):
        assert REPO / "tpu_parallel_torch" / sub in packages
    assert REPO / "tpu_parallel_torch" / "train.py" in PORT_FILES
    assert REPO / "tpu_parallel_torch" / "models" / "mlp.py" in PORT_FILES
    for module in ("fsdp", "spmd", "tp"):
        assert REPO / "tpu_parallel_torch" / "parallel" / f"{module}.py" in PORT_FILES
    assert (REPO / "tests" / "torch_dp_worker.py").is_file()
    assert packages <= scanned
    assert all(p in PORT_FILES for pkg in packages for p in pkg.glob("*.py"))


def test_import_pulls_in_no_jax():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import tpu_parallel_torch, tpu_parallel_torch.models.generate, "
        "tpu_parallel_torch.models.convert, tpu_parallel_torch.core.losses, "
        "tpu_parallel_torch.utils.profiling, tpu_parallel_torch.train_lib, "
        "tpu_parallel_torch.core.accumulate, tpu_parallel_torch.core.optim, "
        "tpu_parallel_torch.core.metrics, tpu_parallel_torch.core.state, "
        "tpu_parallel_torch.data.synthetic, tpu_parallel_torch.serving, "
        "tpu_parallel_torch.serving.engine, tpu_parallel_torch.serving.cache_pool, "
        "tpu_parallel_torch.serving.metrics, tpu_parallel_torch.serving.prefix_cache, "
        "tpu_parallel_torch.serving.request, tpu_parallel_torch.serving.sampling, "
        "tpu_parallel_torch.serving.scheduler, tpu_parallel_torch.obs, "
        "tpu_parallel_torch.obs.registry, tpu_parallel_torch.obs.tracer, "
        "tpu_parallel_torch.utils.logging_utils, tpu_parallel_torch.daemon, "
        "tpu_parallel_torch.daemon.iofaults, tpu_parallel_torch.daemon.journal, "
        "tpu_parallel_torch.serving.kv_hierarchy, tpu_parallel_torch.serving.kv_wire, "
        "tpu_parallel_torch.serving.kv_disk, tpu_parallel_torch.checkpoint, "
        "tpu_parallel_torch.checkpoint.io, tpu_parallel_torch.data.loader, "
        "tpu_parallel_torch.data.packed, tpu_parallel_torch.obs.exporters, "
        "tpu_parallel_torch.train, tpu_parallel_torch.configs, "
        "tpu_parallel_torch.configs.common, tpu_parallel_torch.configs.gpt2_125m_dp, "
        "tpu_parallel_torch.configs.gpt2_125m_corpus, tpu_parallel_torch.configs.gpt2_125m_long, "
        "tpu_parallel_torch.configs.mlp_dp_cpu, tpu_parallel_torch.runtime, "
        "tpu_parallel_torch.runtime.bootstrap, tpu_parallel_torch.runtime.device, "
        "tpu_parallel_torch.runtime.mesh, tpu_parallel_torch.parallel, "
        "tpu_parallel_torch.parallel.dp, tpu_parallel_torch.parallel.fsdp, "
        "tpu_parallel_torch.parallel.spmd, tpu_parallel_torch.parallel.tp, "
        "tpu_parallel_torch.core.rng, "
        "tpu_parallel_torch.models.mlp, tpu_parallel_torch.data.synthetic\n"
        "sys.path.insert(0, 'tests'); import torch_dp_worker\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        f"print(sorted(new & {FORBIDDEN!r}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_default_to_cuda():
    """Without a GPU the default device raises; with one it is used.  The
    same for the trainer, the data loader's device moves, the MLP
    classifier and the CLI."""
    import numpy as np

    from tpu_parallel_torch.data import DataLoader, TokenDataset
    from tpu_parallel_torch.models.mlp import MLPClassifier, MLPConfig
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    ds = TokenDataset(np.arange(400, dtype=np.uint16), 16)
    if torch.cuda.is_available():
        assert GPTLM(tiny_test()).device.type == "cuda"
        assert resolve_device().type == "cuda"
        assert ServingEngine(GPTLM(tiny_test()), n_slots=2).device.type == "cuda"
        assert Trainer(TrainerConfig(model="tiny")).device.type == "cuda"
        assert DataLoader(ds, 4).batch_at(0).tokens.device.type == "cuda"
        assert MLPClassifier(MLPConfig(), 8).head.weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            GPTLM(tiny_test())
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(GPTLM(tiny_test()), n_slots=2)
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(TrainerConfig(model="tiny"))
        with pytest.raises(RuntimeError, match="cuda"):
            DataLoader(ds, 4)
        with pytest.raises(RuntimeError, match="cuda"):
            MLPClassifier(MLPConfig(), 8)
        env = dict(os.environ, PYTHONPATH=str(REPO))
        out = subprocess.run([sys.executable, "-m", "tpu_parallel_torch.train",
                              "--config=gpt2_125m_dp", "--config.model=tiny"], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert GPTLM(tiny_test(), device="cpu").device.type == "cpu"
    assert ServingEngine(GPTLM(tiny_test(), device="cpu"), n_slots=2).device.type == "cpu"
    assert Trainer(TrainerConfig(model="tiny"), device="cpu").device.type == "cpu"
    assert DataLoader(ds, 4, device="cpu").batch_at(0).tokens.device.type == "cpu"
    assert MLPClassifier(MLPConfig(), 8, device="cpu").head.weight.device.type == "cpu"


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A source that cannot build raises; no wrapper falls back.  Without
    nvcc the error names the missing compiler, with it the compile error."""
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc|build failed"):
        build.load_library("broken")
    assert not list(tmp_path.rglob("*.so"))
