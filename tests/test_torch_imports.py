"""The port stands alone: no module of paddle_tpu_torch, and neither
chip_smoke.py nor chip_ab.py, imports jax or anything of the paddle_tpu
package (even a jax-free module there runs paddle_tpu/__init__.py, which
loads jax)."""
import ast
import pathlib

import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/ops/quant_matmul.py",
                 "paddle_tpu_torch/quantization/serving.py",
                 "paddle_tpu_torch/inference/continuous.py",
                 "paddle_tpu_torch/inference/scheduler.py",
                 "paddle_tpu_torch/inference/speculative.py",
                 "paddle_tpu_torch/inference/journal.py",
                 "paddle_tpu_torch/inference/server.py",
                 "paddle_tpu_torch/distributed/fault_tolerance.py",
                 "paddle_tpu_torch/distributed/__init__.py",
                 "paddle_tpu_torch/distributed/watchdog.py",
                 "paddle_tpu_torch/testing/faults.py",
                 "paddle_tpu_torch/testing/__init__.py",
                 "paddle_tpu_torch/ops/moe_gating.py",
                 "paddle_tpu_torch/incubate/distributed/models/moe/gate.py",
                 "paddle_tpu_torch/incubate/distributed/models/moe/"
                 "moe_layer.py",
                 "paddle_tpu_torch/models/llama_moe.py",
                 "paddle_tpu_torch/ops/flashmask_attention.py",
                 "paddle_tpu_torch/nn/functional/attention.py",
                 "paddle_tpu_torch/monitor/__init__.py",
                 "paddle_tpu_torch/monitor/registry.py",
                 "paddle_tpu_torch/monitor/span.py",
                 "paddle_tpu_torch/monitor/trace.py",
                 "paddle_tpu_torch/profiler/__init__.py",
                 "paddle_tpu_torch/profiler/record.py",
                 "paddle_tpu_torch/amp/__init__.py",
                 "paddle_tpu_torch/nn/functional/fused_loss.py",
                 "paddle_tpu_torch/incubate/nn/__init__.py",
                 "paddle_tpu_torch/incubate/nn/functional/__init__.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/jit/train_step.py",
                 "paddle_tpu_torch/nn/layer/conv_pool.py",
                 "paddle_tpu_torch/nn/layer/layers.py",
                 "paddle_tpu_torch/nn/layer/rnn.py",
                 "paddle_tpu_torch/nn/functional/ctc.py",
                 "paddle_tpu_torch/models/crnn.py",
                 "paddle_tpu_torch/vision/__init__.py",
                 "paddle_tpu_torch/vision/models/__init__.py",
                 "paddle_tpu_torch/vision/models/resnet.py",
                 "paddle_tpu_torch/vision/models/small_nets.py",
                 "paddle_tpu_torch/vision/models/mobilenets.py",
                 "paddle_tpu_torch/vision/models/inception.py",
                 "paddle_tpu_torch/nn/layer/transformer.py",
                 "paddle_tpu_torch/nn/layer/activation.py",
                 "paddle_tpu_torch/nn/decode.py",
                 "chip_smoke.py", "chip_ab.py"):
        assert must in names


def _calls_autocast(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and node.attr in ("autocast", "GradScaler")
            and isinstance(node.value, (ast.Name, ast.Attribute))
            and getattr(node.value, "id", getattr(node.value, "attr", ""))
            in ("torch", "amp", "cuda")]


@pytest.mark.parametrize("path", [p for p in FILES
                                  if "paddle_tpu_torch" in p.parts],
                         ids=[str(p.relative_to(ROOT)) for p in FILES
                              if "paddle_tpu_torch" in p.parts])
def test_no_torch_autocast(path):
    """The port's amp casts at its own op sites by the JAX package's op
    lists; no module reaches ``torch.autocast`` or torch's GradScaler."""
    assert not _calls_autocast(path), \
        f"{path.relative_to(ROOT)} uses torch's autocast"
