"""The PyTorch/CUDA port stands alone: it imports with jax blocked, no source
line of it imports jax or the reference package, and its entry points run on
the GPU unless the caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.core.flow import DesignFlow
from repro_torch.core.reader import cnn_to_ir
from repro_torch.core.writers.qtorch_writer import QTorchWriter
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.dse import DesignSpaceExplorer
from repro_torch.kernels import _build
from repro_torch.models import cnn
from repro_torch.quant.qtypes import DatatypeConfig

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) >= 20


def test_lm_slice_modules_are_among_those_imported_with_jax_blocked():
    """The LM serving path's modules are walked by the jax-blocked import
    above (a module missing from the package would not be)."""
    lm = {"repro_torch.configs.base", "repro_torch.configs.mamba2_1_3b",
          "repro_torch.perf", "repro_torch.models.common",
          "repro_torch.models.params", "repro_torch.models.ssm",
          "repro_torch.models.transformer",
          "repro_torch.kernels.ssd_scan.ref",
          "repro_torch.kernels.ssd_scan.ops",
          "repro_torch.runtime.model_api", "repro_torch.runtime.serve",
          "repro_torch.launch.serve"}
    assert lm <= set(_modules())


def test_attention_slice_modules_are_among_those_imported_with_jax_blocked():
    """Attention and the hybrid and dense configs are walked by the
    jax-blocked import above."""
    mods = {"repro_torch.models.attention", "repro_torch.configs.hymba_1_5b",
            "repro_torch.configs.qwen1_5_0_5b",
            "repro_torch.configs.phi3_mini_3_8b",
            "repro_torch.configs.h2o_danube3_4b",
            "repro_torch.configs.codeqwen1_5_7b"}
    assert mods <= set(_modules())


def test_dse_slice_modules_are_among_those_imported_with_jax_blocked():
    """The design-space explorer's modules (the explorer, its budget and
    front, roofline's CNN terms) are walked by the jax-blocked import above."""
    dse = {"repro_torch.dse", "repro_torch.dse.budget",
           "repro_torch.dse.pareto", "repro_torch.dse.explorer",
           "repro_torch.launch.roofline"}
    assert dse <= set(_modules())


def test_fleet_slice_modules_are_among_those_imported_with_jax_blocked():
    """The robust serving stack (fault sources, weight-memory integrity, the
    fleet router) is walked by the jax-blocked import above, and the names
    its modules export resolve."""
    fleet = {"repro_torch.runtime.ft", "repro_torch.runtime.integrity",
             "repro_torch.runtime.fleet", "repro_torch.core.adaptive",
             "repro_torch.quant.pack"}
    assert fleet <= set(_modules())
    from repro_torch.runtime import fleet as f, integrity
    assert set(f.__all__) <= set(dir(f))
    assert set(integrity.__all__) <= set(dir(integrity))


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_source_line_imports_jax_or_repro(path):
    for i, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        assert not _FORBIDDEN.match(line), f"{path}:{i}: {line.strip()}"


def _graph():
    params = cnn.init_params(CNNConfig(), torch.Generator().manual_seed(0))
    return cnn_to_ir(CNNConfig(), params)


@pytest.mark.parametrize("make", [
    lambda g: DesignFlow(g),
    lambda g: TorchWriter(g),
    lambda g: QTorchWriter(g),
    lambda g: StreamWriter(g),
    lambda g: DesignSpaceExplorer(g, (np.zeros((1, 28, 28, 1), np.float32),)),
], ids=["DesignFlow", "TorchWriter", "QTorchWriter", "StreamWriter",
        "DesignSpaceExplorer"])
def test_entry_points_default_to_cuda_and_refuse_without_it(make,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(_graph())


def test_flow_runs_on_the_cpu_only_when_asked():
    flow = DesignFlow(_graph(), device="cpu")
    res = flow.run(("qtorch",), DatatypeConfig(8, 8))
    assert res.writers["qtorch"].device == torch.device("cpu")
    x = np.random.default_rng(0).random((1, 28, 28, 1), np.float32)
    assert res.batched["qtorch"](x).device.type == "cpu"
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No kernel is built at import; building without nvcc fails loudly."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert len(_build.source_hash()) == 16
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)


def test_qtorch_refuses_the_unported_float_activation_mode():
    """The float-activation mode is ported now: a D16 qtorch writer builds
    and runs its hot ops on float activations (no int8 codes anywhere)
    instead of refusing."""
    w = QTorchWriter(_graph(), DatatypeConfig(16, 8), device="cpu")
    assert not w.int8_act_on
    x = np.random.default_rng(0).random((1, 28, 28, 1), np.float32)
    y, env = w.build(capture=True)(x)
    assert y.shape == (1, 10) and torch.isfinite(y).all()
    assert all(torch.is_floating_point(v) for k, v in env.items()
               if isinstance(v, torch.Tensor) and k in w._fused_act)
    assert w._fused_act, "no hot op ran the fused float epilogue"
