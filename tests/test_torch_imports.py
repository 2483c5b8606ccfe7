"""The port stands alone: nothing under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "jaxlib", "flax", "optax")


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def test_port_has_the_expected_modules():
    names = {str(p.relative_to(PORT)) for p in FILES[:-1]}
    for want in ("__init__.py", "device.py", "hw.py", "core/costmodel.py",
                 "core/dse.py", "kernels/build.py", "kernels/dse_sweep.py",
                 "kernels/ops.py", "telemetry/__init__.py",
                 "telemetry/metrics.py", "telemetry/trace.py",
                 "dse_campaign/space.py", "dse_campaign/frontier.py",
                 "dse_campaign/config.py", "dse_campaign/store.py",
                 "dse_campaign/runner.py", "dse_campaign/__init__.py",
                 "kernels/conv2d.py", "configs/__init__.py", "configs/base.py",
                 "configs/resnet50.py", "models/__init__.py",
                 "models/layers.py", "models/resnet.py", "models/api.py",
                 "models/transformer.py", "kernels/flash_attention.py",
                 "data/__init__.py", "data/pipeline.py", "kernels/ssd_scan.py",
                 "models/ssd.py", "models/mamba.py", "core/features.py",
                 "core/predictors.py", "core/dataset.py",
                 "dse_campaign/adaptive.py", "serving/__init__.py",
                 "serving/frontier_index.py", "serving/engine.py",
                 "select.py", "launch/__init__.py", "launch/serve.py",
                 "runtime/__init__.py", "runtime/fault_tolerance.py",
                 "dse_campaign/fabric.py", "dse_campaign/chaos.py",
                 "optim/__init__.py", "optim/adamw.py", "optim/adafactor.py",
                 "optim/compression.py", "checkpoint/__init__.py",
                 "checkpoint/store.py", "launch/train.py", "core/hxa.py",
                 "core/offload.py", "launch/lowering.py",
                 "launch/dryrun.py", "models/zamba.py"):
        assert want in names
    for arch in ("mamba2_130m", "deepseek_v3_671b", "deepseek_v2_236b",
                 "qwen3_14b", "qwen2_72b", "granite_20b", "stablelm_1_6b",
                 "paligemma_3b", "whisper_small", "zamba2_1_2b", "resnet50"):
        assert f"configs/{arch}.py" in names
    assert (PORT / "kernels" / "csrc" / "dse_sweep.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "conv2d.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "ssd_scan.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "flash_attention_bwd.cu").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(root, line) for root, line in imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


@pytest.mark.parametrize("path", FILES[:-1],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_compile_or_triton_or_extension_loader(path):
    """The kernels are nvcc + ctypes: no ``torch.compile``, no Triton, no
    ``torch.utils.cpp_extension`` anywhere in the package."""
    src = path.read_text()
    assert "torch.compile" not in src
    assert "cpp_extension" not in src
    assert "triton" not in {r for r, _ in imported_roots(path)}


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.hw, repro_torch.device\n"
        "import repro_torch.core.costmodel, repro_torch.core.dse\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.telemetry, repro_torch.dse_campaign\n"
        "import repro_torch.kernels.conv2d, repro_torch.configs.base\n"
        "import repro_torch.models.api, repro_torch.models.resnet\n"
        "import repro_torch.models.layers, repro_torch.data.pipeline\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.ssd\n"
        "import repro_torch.models.mamba, repro_torch.models.zamba\n"
        "import repro_torch.core.features, repro_torch.core.predictors\n"
        "import repro_torch.core.dataset, repro_torch.dse_campaign.adaptive\n"
        "import repro_torch.serving, repro_torch.serving.frontier_index\n"
        "import repro_torch.serving.engine, repro_torch.select\n"
        "import repro_torch.launch, repro_torch.launch.serve\n"
        "import repro_torch.runtime, repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.dse_campaign.fabric\n"
        "import repro_torch.dse_campaign.chaos\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.optim.adafactor, repro_torch.optim.compression\n"
        "import repro_torch.checkpoint.store, repro_torch.launch.train\n"
        "repro_torch.configs.base.all_configs()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import (build, conv2d, dse_sweep,\n"
        "                                 flash_attention, ssd_scan)\n"
        "assert dse_sweep._bound is None and conv2d._bound is None\n"
        "assert flash_attention._bound is None and ssd_scan._bound is None\n"
        "assert flash_attention._bwd_bound is None\n"
        "assert not build._libs\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line.  (Skipped where there is a card: there it runs for real.)"""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; run `python3 chip_smoke.py`")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
