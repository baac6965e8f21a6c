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


def test_spmd_slice_modules_are_among_those_imported_with_jax_blocked():
    """The sharding rules, the mesh and the distributed writer are walked
    by the jax-blocked import above, and ``"dist"`` is a flow target."""
    from repro_torch.core.flow import WRITERS
    from repro_torch.core.writers.dist_writer import DistWriter
    mods = {"repro_torch.sharding", "repro_torch.launch.mesh",
            "repro_torch.core.writers.dist_writer"}
    assert mods <= set(_modules())
    assert WRITERS["dist"] is DistWriter


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


def test_table2_slice_modules_are_among_those_imported_with_jax_blocked():
    """The procedural dataset is walked by the jax-blocked import above, and
    the Table II path's names resolve."""
    assert {"repro_torch.data", "repro_torch.data.mnist"} <= set(_modules())
    from repro_torch.core.writers import registry
    from repro_torch.data import mnist
    from repro_torch.kernels.qmatmul import ops, ref
    from repro_torch.quant import fixedpoint, ptq, qtypes
    for mod, names in ((mnist, ("make_dataset", "batches")),
                       (cnn, ("loss_fn", "accuracy")),
                       (qtypes, ("FLOAT", "TABLE2_POINTS")),
                       (fixedpoint, ("quant_error",)),
                       (ptq, ("quantize_tree_fixed", "ActQuant",
                              "calibrate_acts", "act_code_scales")),
                       (registry, ("registered_ops",)),
                       (ops, ("qmatmul", "qmatmul_plain")),
                       (ref, ("qmatmul_ref",))):
        assert all(hasattr(mod, n) for n in names), mod.__name__


def test_autotune_slice_modules_import_alone_with_jax_blocked():
    """The tile autotuner and the token stream are walked by the
    jax-blocked import above, and each also imports on its own with jax and
    the reference package blocked, pulling in neither; the autotune names
    resolve."""
    mods = {"repro_torch.kernels.autotune", "repro_torch.data.tokens"}
    assert mods <= set(_modules())
    for mod in sorted(mods):
        code = ("import sys, importlib\n"
                "for m in ('jax', 'jaxlib', 'repro'):\n"
                "    sys.modules[m] = None\n"
                f"importlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr
    from repro_torch.kernels import autotune
    from repro_torch.kernels.qconv_dw import ops as dwops
    from repro_torch.kernels.qmatmul import ops as qops
    for mod, names in ((autotune, ("CACHE_SCHEMA", "CacheFormatError",
                                   "disk_put", "tuned_entries",
                                   "autotune_cache_path", "time_candidates",
                                   "choose")),
                       (qops, ("pick_blocks", "candidate_tiles",
                               "AUTOTUNE_CACHE_ENV", "autotune_cache_path",
                               "_disk_key")),
                       (dwops, ("pick_blocks_dw", "dw_tiles",
                                "candidate_dw_tiles"))):
        assert all(hasattr(mod, n) for n in names), mod.__name__
    assert qops._disk_state is autotune._disk_state


def test_moe_encdec_slice_modules_import_alone_with_jax_blocked():
    """The MoE block, the encoder-decoder and the four configs of their
    families (and the vision stub's) are walked by the jax-blocked import
    above, and the two model modules each also import on their own with
    jax and the reference package blocked, pulling in neither; their names
    resolve."""
    mods = {"repro_torch.models.moe", "repro_torch.models.encdec",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.whisper_base",
            "repro_torch.configs.phi3_vision_4_2b"}
    assert mods <= set(_modules())
    for mod in ("repro_torch.models.moe", "repro_torch.models.encdec"):
        code = ("import sys, importlib\n"
                "for m in ('jax', 'jaxlib', 'repro'):\n"
                "    sys.modules[m] = None\n"
                f"importlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr
    from repro_torch.models import encdec, moe
    for mod, names in ((moe, ("MoELayerParams", "route", "aux_losses",
                              "_expert_ffn", "moe_shard_body", "moe_block")),
                       (encdec, ("encode", "_cross_kv", "forward",
                                 "EncDecDecodeState", "init_decode_state",
                                 "decode_step"))):
        assert all(hasattr(mod, n) for n in names), mod.__name__


def test_training_slice_modules_import_alone_with_jax_blocked():
    """The training path (AdamW, gradient compression, pruning, the
    checkpointer, the train step, the fault-tolerant loop and the launcher)
    is walked by the jax-blocked import above, each module also imports on
    its own with jax and the reference package blocked, pulling in
    neither, and the names of the slice resolve."""
    mods = {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.quant.gradcomp", "repro_torch.quant.pruning",
            "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.runtime.train", "repro_torch.runtime.ft",
            "repro_torch.launch.train"}
    assert mods <= set(_modules())
    for mod in sorted(mods):
        code = ("import sys, importlib\n"
                "for m in ('jax', 'jaxlib', 'repro'):\n"
                "    sys.modules[m] = None\n"
                f"importlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, timeout=300)
        assert out.returncode == 0, (mod, out.stderr)
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.quant import gradcomp, pruning
    from repro_torch.runtime import ft, model_api, train
    for mod, names in ((adamw, ("OptConfig", "OptState", "init_opt_state",
                                "schedule", "global_norm", "_NO_DECAY",
                                "apply_updates")),
                       (gradcomp, ("init_error_state", "_q_int8",
                                   "compress_decompress", "compress_tree")),
                       (pruning, ("magnitude_prune", "nm_prune", "prune_tree",
                                  "zero_weight_fraction")),
                       (checkpoint, ("_flatten", "_unflatten", "save",
                                     "AsyncCheckpointer", "list_steps",
                                     "latest_step", "restore",
                                     "_storage_view", "_logical_view")),
                       (train, ("TrainState", "init_train_state",
                                "make_train_step", "train_state_from_jax")),
                       (ft, ("LoopResult", "run_training", "_to_tree",
                             "_to_state")),
                       (model_api, ("loss_fn", "forward_logits")),
                       (launch_train, ("main",))):
        assert all(hasattr(mod, n) for n in names), mod.__name__


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


def test_dryrun_slice_modules_are_among_those_imported_with_jax_blocked():
    """The dry-run's modules (the abstract cell specs and the traced,
    counted step) are walked by the jax-blocked import above, and their
    entry points resolve."""
    mods = {"repro_torch.launch.specs", "repro_torch.launch.dryrun"}
    assert mods <= set(_modules())
    from repro_torch.launch import dryrun, roofline, specs
    for mod, names in ((specs, ("input_specs", "batch_sharding",
                                "abstract_decode_state",
                                "decode_state_sharding",
                                "abstract_train_state",
                                "abstract_inference_params",
                                "param_sharding_for")),
                       (dryrun, ("run_cell", "trace_cell", "StepCounter",
                                 "main")),
                       (roofline, ("CollectiveStats", "parse_collectives",
                                   "RooflineReport", "model_flops_for"))):
        assert all(hasattr(mod, n) for n in names), mod.__name__
