"""The vision and OCR training paths on the card (ResNet, CRNN, and a
MobileNetV3 of depthwise convolutions): the graphed
``TrainStep`` against its eager twin, bit for bit (losses, parameters and
batch-norm buffers), runs repeated from one start, and steps that make no
blocking sync.  These need a CUDA device; elsewhere they skip.  Run them
on the card with

    python -m pytest --noconftest tests/test_torch_vision_card.py
"""
import pytest
import torch

from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
from paddle_tpu_torch.models import crnn_tiny
from paddle_tpu_torch.nn import CrossEntropyLoss, Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.vision.models import mobilenet_v3_small, resnet18

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and cuDNN have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _case(name, dev):
    """(make(cls), inputs, labels) of a small seeded case on ``dev``."""
    gen = torch.Generator().manual_seed(3)
    if name == "crnn_tiny":
        x = torch.randn(8, 1, 16, 64, generator=gen).to(dev)
        y = torch.randint(1, 8, (8, 8), generator=gen).to(dev)
        ilen = torch.full((8,), 16, device=dev)
        llen = torch.full((8,), 8, device=dev)

        def make(cls):
            net = crnn_tiny(8, img_height=16, device=dev, seed=0)
            return cls(net, lambda o, lab: F.ctc_loss(o, lab, ilen, llen),
                       Adam(learning_rate=1e-3,
                            parameters=net.parameters()))
        return make, x, y
    x = torch.randn(16, 3, 32, 32, generator=gen).to(dev)
    y = torch.randint(0, 10, (16,), generator=gen).to(dev)
    if name == "mobilenet_v3_small_o1":
        # depthwise convolutions under the deterministic cuDNN flags
        def make(cls):
            net = mobilenet_v3_small(scale=0.5, num_classes=10, device=dev,
                                     seed=0)
            for m in net.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
            return cls(net, CrossEntropyLoss(), Momentum(
                learning_rate=0.1, momentum=0.9, weight_decay=4e-5,
                parameters=net.parameters()), amp_level="O1")
        return make, x, y
    level = "O1" if name == "resnet18_o1" else "O0"

    def make(cls):
        net = resnet18(num_classes=10, device=dev, seed=0)
        return cls(net, CrossEntropyLoss(), Momentum(
            learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
            parameters=net.parameters()), amp_level=level)
    return make, x, y


def _run(step, x, y, n):
    losses = torch.stack([step(x, y) for _ in range(n)])
    state = {k: v.detach().clone()
             for k, v in step.model.state_dict().items()}
    return losses, state


CASES = ["resnet18_f32", "resnet18_o1", "crnn_tiny", "mobilenet_v3_small_o1"]


@pytest.mark.parametrize("name", CASES)
def test_graphed_equals_eager_and_repeats(name, dev):
    """Three graphed steps (a capture, then replays) equal three eager
    ones bit for bit, the running statistics included, and a second
    graphed run from the same seed equals the first."""
    make, x, y = _case(name, dev)
    graphed = make(TrainStep)
    g_losses, g_state = _run(graphed, x, y, 3)
    assert graphed.captures == 1 and graphed.replays == 2
    e_losses, e_state = _run(make(EagerTrainStep), x, y, 3)
    again_losses, again_state = _run(make(TrainStep), x, y, 3)
    assert torch.isfinite(g_losses).all()
    assert torch.equal(g_losses, e_losses)
    assert torch.equal(g_losses, again_losses)
    assert any(k.endswith("_mean") for k in g_state)
    for k in g_state:
        assert torch.equal(g_state[k], e_state[k]), k
        assert torch.equal(g_state[k], again_state[k]), k


@pytest.mark.parametrize("name", ["resnet18_o1", "crnn_tiny"])
def test_steps_make_no_blocking_sync(name, dev):
    """After the capture, graphed replays and eager steps run under
    ``set_sync_debug_mode("error")``: any blocking copy or sync raises."""
    make, x, y = _case(name, dev)
    graphed, eager = make(TrainStep), make(EagerTrainStep)
    graphed(x, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            graphed(x, y)
            eager(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert graphed.replays == 2
