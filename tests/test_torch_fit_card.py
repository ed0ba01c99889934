"""The fit path on the card: the DataLoader's device stage, the eager
optimizer step without a blocking sync, and ZeRO offload's pinned host
state with its copies captured in a CUDA graph.  These need a CUDA
device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_fit_card.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.distributed import group_sharded_parallel, sharding
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.models.bert import (BertConfig,
                                          BertForSequenceClassification)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory, CUDA streams and "
                    "graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


class Tokens(tio.Dataset):
    def __init__(self, n, seq, vocab, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.integers(0, vocab, (n, seq)).astype(np.int64)
        self.y = rng.integers(0, 2, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_device_stage_equals_to_cuda(dev):
    """Every staged batch is bit-identical to ``.to(dev)`` of the host
    batch, arrives on the card, and survives the loader's next copies
    (the consumer's stream waited on the copy's event)."""
    ds = Tokens(37, 64, 1000)
    host = list(tio.DataLoader(ds, batch_size=8))
    staged = list(tio.DataLoader(ds, batch_size=8, device_prefetch=True,
                                 device=dev, device_prefetch_depth=2))
    assert len(staged) == len(host) == 5
    for (hx, hy), (sx, sy) in zip(host, staged):
        assert sx.device == dev and sy.device == dev
        assert torch.equal(sx, hx.to(dev)) and torch.equal(sy, hy.to(dev))


def test_optimizer_step_makes_no_blocking_sync(dev):
    """The eager step writes its rate and step number from a pinned slot:
    under ``set_sync_debug_mode("error")`` any blocking copy or sync
    raises.  The numbers equal the rule's with scalars built directly."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(tnn.Linear(64, 64, bias=True),
                                tnn.GELU()).to(dev)
    with torch.no_grad():
        model[0].weight.normal_(0.0, 0.1)
    ref = torch.nn.Sequential(tnn.Linear(64, 64, bias=True),
                              tnn.GELU()).to(dev)
    ref.load_state_dict(model.state_dict())
    opt = toptim.AdamW(learning_rate=1e-3, parameters=model.parameters())
    ref_opt = toptim.AdamW(learning_rate=1e-3, parameters=ref.parameters())
    x = torch.randn(16, 64, device=dev)
    for step in range(1, 4):
        model(x).square().mean().backward()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        opt.clear_grad()
        ref(x).square().mean().backward()
        params = [p for p in ref.parameters()]
        ref_opt._global_step += 1
        ref_opt._apply_update(
            params, [p.grad for p in params],
            torch.tensor(1e-3, dtype=torch.float32, device=dev),
            torch.tensor(step, dtype=torch.int32, device=dev))
        ref_opt.clear_grad()
    for p, r in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, r)


@pytest.mark.parametrize("rows", [2, 30522], ids=["token_types", "words"])
def test_embedding_backward_repeats_bit_for_bit(dev, rows):
    """The port's Embedding on the card gives the same table gradient on
    every backward (torch's CUDA backward varies for rows many tokens
    share), within 1e-4 of torch's own (an f32 sum of up to 4096 rows)
    and 1e-6 of the CPU's ``sorted_row_sums``."""
    gen = torch.Generator().manual_seed(2)
    ids = torch.zeros(32, 128, dtype=torch.long) if rows == 2 else \
        torch.randint(0, rows, (32, 128), generator=gen)
    grad = torch.randn(32, 128, 64, generator=gen)
    emb = tnn.Embedding(rows, 64, device=dev)
    with torch.no_grad():
        emb.weight.normal_()
    got = []
    for _ in range(3):
        emb.weight.grad = None
        emb(ids.to(dev)).backward(grad.to(dev))
        got.append(emb.weight.grad.clone())
    assert all(torch.equal(got[0], g) for g in got[1:])
    w = emb.weight.detach().clone().requires_grad_()
    torch.nn.functional.embedding(ids.to(dev), w).backward(grad.to(dev))
    # torch's own backward sums 4096 tokens of a row in f32
    torch.testing.assert_close(got[0], w.grad, rtol=1e-4, atol=1e-4)
    from paddle_tpu_torch.nn.layer.common import sorted_row_sums
    torch.testing.assert_close(got[0].cpu(), sorted_row_sums(ids, grad, rows),
                               rtol=1e-6, atol=1e-6)


def _offload_run(dev, offload, graphed, steps=4):
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        tnn.Linear(256, 512, bias=True), tnn.GELU(),
        tnn.Linear(512, 256, bias=True))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    model = model.to(dev, torch.bfloat16)
    opt = toptim.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                       multi_precision=True)
    model, opt, _ = group_sharded_parallel(model, opt, "os_g",
                                           offload=offload)
    cls = TrainStep if graphed else EagerTrainStep
    step = cls(model, lambda o, y: ((o.float() - y) ** 2).mean(), opt)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(32, 256, device=dev, generator=g).to(torch.bfloat16)
    y = torch.randn(32, 256, device=dev, generator=g)
    losses = torch.stack([step(x, y) for _ in range(steps)])
    torch.cuda.synchronize()
    return losses, model, opt, step


def test_offloaded_state_pinned_and_graphed_equals_no_offload(dev,
                                                              monkeypatch):
    """bf16 parameters, AdamW with f32 masters, groups of at most 2^17
    elements: every state tensor and master is a pinned CPU tensor
    between steps; the graphed offloaded trainer (its copies captured)
    equals the graphed trainer without offload and the eager offloaded
    one bit for bit, and a timed replay captures nothing."""
    monkeypatch.setattr(sharding, "OFFLOAD_GROUP_NUMEL", 1 << 17)
    got = _offload_run(dev, True, True)
    for want in (_offload_run(dev, False, True),
                 _offload_run(dev, True, False)):
        assert torch.equal(got[0], want[0])
        for p, q in zip(got[1].parameters(), want[1].parameters()):
            assert torch.equal(p, q)
    opt = got[2]
    homes = [t for acc in opt._accumulators.values() for t in acc.values()] \
        + list(opt._master_weights.values())
    assert len(homes) == 3 * 4
    assert all(t.device.type == "cpu" and t.is_pinned() for t in homes)
    ref = _offload_run(dev, False, True)[2]
    sd, ref_sd = opt.state_dict(), ref.state_dict()
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, ref_sd[k].cpu()), k
    step = got[3]
    assert step.captures == 1 and step.replays == 3


def test_bert_fit_matches_eager_loop(dev):
    """A small BERT through ``Model.fit`` (device-prefetched batches,
    dropout 0.1 from the model's generator) gives the losses of an
    explicit eager loop over the same batches and weights, bit for bit."""
    cfg = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=64)
    ds = Tokens(48, 64, 512)

    def model():
        net = BertForSequenceClassification(cfg, device=dev, seed=3)
        return net, toptim.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters())

    net, opt = model()
    np.random.seed(4)
    hist = Model(net).prepare(opt, tnn.CrossEntropyLoss(), Accuracy()).fit(
        ds, batch_size=16, epochs=1, verbose=0)
    net, opt = model()
    np.random.seed(4)
    loss_fn = tnn.CrossEntropyLoss()
    want = []
    net.train()
    for x, y in tio.DataLoader(ds, batch_size=16, shuffle=True):
        loss = loss_fn(net(x.to(dev)), y.to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.detach()))
    assert hist["loss"] == want
