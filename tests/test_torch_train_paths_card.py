"""The rest of the training path on the card: the fused linear + cross
entropy (``torch.mm(..., out_dtype=torch.float32)`` for bf16 operands)
against its plain version on the CPU, a GShard MoE LLaMA as a graphed
``TrainStep`` (fresh random keeps on every replay), ``GradScaler`` with
f16 gradients, and ``LBFGS`` against the CPU.  These need a CUDA
device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_train_paths_card.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama_moe import (LlamaMoeConfig,
                                               LlamaMoeForCausalLM)
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: aten::mm.dtype, CUDA graphs and "
                    "the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fused(h, w, lab, b, chunk):
    h = h.clone().requires_grad_()
    w = w.clone().requires_grad_()
    b = b.clone().requires_grad_()
    loss = fused_linear_cross_entropy(h, w, lab, bias=b, chunk_rows=chunk)
    loss.backward()
    return [t.detach().float().cpu() for t in (loss, h.grad, w.grad, b.grad)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_ce_matches_plain(dev, dtype):
    """Loss and dh / dW / db of 1000 rows (a tail chunk of 232), vocab
    4000, hidden 256, a tenth of the labels ignored: the card's route
    against the CPU's on the same inputs.  f32: summation order only
    (loss 1e-5, gradients 1e-4 of their largest entry); bf16: the same
    f32 products, then one bf16 rounding of each gradient (1e-2)."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(1000, 256, generator=g).to(dtype)
    w = (0.05 * torch.randn(4000, 256, generator=g)).to(dtype)
    b = (0.1 * torch.randn(4000, generator=g)).to(dtype)
    lab = torch.randint(0, 4000, (1000,), generator=g)
    lab[torch.rand(1000, generator=g) < 0.1] = -100
    got = _fused(h.to(dev), w.to(dev), lab.to(dev), b.to(dev), 256)
    want = _fused(h, w, lab, b, 256)
    assert got[0].dtype == torch.float32
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=tol * float(r.abs().max()))


def test_gshard_moe_graphed_draws_fresh_keeps(dev):
    """A small f32 GShard MoE LLaMA whose gates draw their random keep
    from their own CUDA generators: the graphed step captures with the
    generators registered, and two replays route on different uniforms
    (a graph that baked the capture's draw would repeat it)."""
    cfg = LlamaMoeConfig(vocab_size=256, hidden_size=256,
                         intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, num_experts=4,
                         gate_type="gshard")
    model = LlamaMoeForCausalLM(cfg, device=dev, seed=0)
    keeps = {}
    for i, layer in enumerate(model.model.layers):
        gate = layer.moe.gate
        gate.generator = torch.Generator(device=dev).manual_seed(10 + i)
        real = gate._random_keep

        def spy(n, device, real=real, i=i):
            keeps[i] = real(n, device)
            return keeps[i]
        gate._random_keep = spy

    def loss_fn(outputs, labels):
        logits, aux = outputs
        return TF.cross_entropy(logits.reshape(-1, 256),
                                labels.reshape(-1)) + aux

    step = TrainStep(model, loss_fn, toptim.AdamW(
        learning_rate=1e-3, parameters=model.parameters()))
    g = torch.Generator().manual_seed(1)
    ids, lab = (torch.randint(0, 256, (2, 64), generator=g).to(dev)
                for _ in range(2))
    losses, drawn = [], []
    for _ in range(3):
        losses.append(step(ids, lab))
        drawn.append(keeps[0].clone())
    torch.cuda.synchronize()
    assert step.captures == 1 and step.replays == 2
    assert not torch.equal(drawn[1], drawn[2])
    assert not torch.equal(drawn[0], drawn[1])
    assert torch.isfinite(torch.stack(losses)).all()


def test_grad_scaler_f16_skips_on_inf_as_on_cpu(dev):
    """The same f16 parameter, gradients and injected overflows on the
    card and on the CPU: the same scales and skipped steps, the same
    parameters."""
    out = []
    for where in (dev, torch.device("cpu")):
        w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.5],
                                            dtype=torch.float16,
                                            device=where))
        opt = toptim.SGD(learning_rate=0.1, parameters=[w])
        scaler = amp.GradScaler(init_loss_scaling=1024.0,
                                incr_every_n_steps=2)
        scales = []
        for i in range(6):
            x = torch.tensor([0.5, 1.0, -1.5], dtype=torch.float16,
                             device=where)
            if i in (1, 4):
                x = x * 60000.0       # the scaled f16 gradient overflows
            scaler.scale((w * x).sum()).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            scales.append(scaler.get_init_loss_scaling())
        out.append((scales, w.detach().cpu()))
    assert out[0][0] == out[1][0]
    assert out[0][0][1] < 1024.0
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)


def test_lbfgs_on_card_matches_cpu(dev):
    """Four strong-Wolfe LBFGS steps of a linear regression with L2
    decay: the card's parameters within 1e-5 of the CPU's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = (x @ rng.standard_normal((8, 1)) + 0.3).astype(np.float32)
    w0 = (0.1 * rng.standard_normal((1, 8))).astype(np.float32)
    results = []
    for where in (dev, torch.device("cpu")):
        lin = tnn.Linear(8, 1, bias=True, device=where)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor(w0))
        opt = toptim.LBFGS(learning_rate=0.5, max_iter=5,
                           line_search_fn="strong_wolfe",
                           parameters=list(lin.parameters()),
                           weight_decay=0.01)
        tx, ty = torch.tensor(x, device=where), torch.tensor(y, device=where)

        def closure():
            opt.clear_grad()
            loss = ((lin(tx) - ty) ** 2).mean()
            loss.backward()
            return loss

        for _ in range(4):
            opt.step(closure)
        results.append([p.detach().cpu() for p in lin.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
