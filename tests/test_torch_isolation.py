"""The port stands alone: it imports neither jax nor anything of the
reference package, and it never runs on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm
from repro_torch.kernels import quantize as quant
from repro_torch.kernels import rg_lru
from repro_torch.launch import train
from repro_torch.models.registry import build_model

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, "
        "repro_torch.checkpoint.bbckpt, repro_torch.checkpoint.convert, "
        "repro_torch.models.rglru, repro_torch.kernels.rg_lru, "
        "repro_torch.kernels.mlstm, repro_torch.models.xlstm, "
        "repro_torch.data.pipeline, repro_torch.optim.schedule, "
        "repro_torch.optim.grad, repro_torch.optim.adamw, "
        "repro_torch.runtime.train_step, repro_torch.launch.train, "
        "repro_torch.models.moe, repro_torch.models.mla, "
        "repro_torch.configs.deepseek_v3_671b, repro_torch.launch.mesh, "
        "repro_torch.launch.sharding, repro_torch.launch.elastic, "
        "repro_torch.models.moe_sharded\n"
        "from repro_torch.configs.base import get_config\n"
        "get_config('recurrentgemma-9b'), get_config('xlstm-350m')\n"
        "get_config('deepseek-v3-671b')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                         r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)
    offenders = [str(p.relative_to(SRC))
                 for p in (SRC / "repro_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_refuse_cuda_without_a_card(no_cuda):
    model = build_model(reduced(get_config("starcoder2-3b")))
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)                       # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)


def test_kernel_wrappers_refuse_cpu_tensors(no_cuda):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize_blockwise(torch.zeros(2048))
    with pytest.raises(ValueError, match="CUDA"):
        quant.dequantize_blockwise(torch.zeros(2048, dtype=torch.int8),
                                   torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        rg_lru.rg_lru(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm(q, q, q, torch.zeros(1, 8, 2), torch.zeros(1, 8, 2))
    assert fa.flash_attention.launches == 0
    assert quant.quantize_blockwise.launches == 0
    assert rg_lru.rg_lru.launches == 0
    assert mlstm.mlstm.launches == 0


def test_train_entry_points_refuse_cuda_without_a_card(no_cuda):
    cfg = reduced(get_config("xlstm-350m"))
    with pytest.raises(RuntimeError, match="cuda"):
        train.build(cfg)                    # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "xlstm-350m", "--reduced", "--steps", "1"])


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_examples_load_no_jax_and_no_reference_module():
    """Each ``examples/torch_*.py`` loaded in a fresh interpreter (its
    ``main`` not run) brings in neither jax nor anything of the reference."""
    examples = sorted(EXAMPLES.glob("torch_*.py"))
    assert [p.name for p in examples] == [
        "torch_quickstart.py", "torch_restart_demo.py", "torch_serve_lm.py",
        "torch_train_lm.py"]
    code = (
        "import importlib.util, sys\n"
        f"for path in {[str(p) for p in examples]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_example_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                         r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)
    examples = sorted(EXAMPLES.glob("torch_*.py"))
    assert len(examples) == 4
    offenders = [p.name for p in examples if pattern.search(p.read_text())]
    assert offenders == []
