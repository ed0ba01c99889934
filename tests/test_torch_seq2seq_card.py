"""The Transformer encoder-decoder on the card: the graphed
``TrainStep`` against its eager twin bit for bit, the flash kernels'
launches a step (the encoder's self-attention and the decoder's
cross-attention take the kernels; the decoder's masked self-attention
takes the plain softmax), steps that make no blocking sync, and a beam
search whose steps launch the flash forward over the caches and whose
ids equal the CPU's.  These need a CUDA device; elsewhere they skip.
Run them on the card with

    python -m pytest --noconftest tests/test_torch_seq2seq_card.py
"""
import pytest
import torch

from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
from paddle_tpu_torch.nn import (BeamSearchDecoder, CrossEntropyLoss,
                                 Embedding, Linear, MultiHeadAttention,
                                 Transformer, dynamic_decode)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import Adam

pytestmark = pytest.mark.cuda

D, HEADS, LAYERS, FF, V, S = 128, 2, 2, 256, 500, 32
FLASH = (fa.flash_attention_cuda, fa.flash_attention_bwd_dkv_cuda,
         fa.flash_attention_bwd_dq_cuda)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels and CUDA "
                    "graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


class Seq2Seq(torch.nn.Module):
    """Token and position embeddings around ``Transformer`` (2 heads of
    64, the kernels' head width) and the output Linear."""

    def __init__(self, dev, seed=0, dropout=0.0):
        super().__init__()
        self.transformer = Transformer(D, HEADS, LAYERS, LAYERS, FF,
                                       dropout, device=dev, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        self.src_emb, self.tgt_emb, self.pos_emb = (
            Embedding(n, D, device=dev) for n in (V, V, 64))
        self.out = Linear(D, V, bias=True, device=dev)
        with torch.no_grad():
            for emb in (self.src_emb, self.tgt_emb, self.pos_emb):
                emb.weight.normal_(0.0, D ** -0.5, generator=gen)
            self.out.weight.normal_(0.0, 0.05, generator=gen)
            self.out.bias.zero_()
        self.register_buffer(
            "mask", self.transformer.generate_square_subsequent_mask(S))

    def embed(self, emb, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return emb(ids) + self.pos_emb(pos)

    def forward(self, src, tgt):
        h = self.transformer(self.embed(self.src_emb, src),
                             self.embed(self.tgt_emb, tgt),
                             tgt_mask=self.mask)
        return self.out(h)


def _batch(dev, b=4):
    gen = torch.Generator().manual_seed(5)
    src, tgt = (torch.randint(0, V, (b, S + 1), generator=gen).to(dev)
                for _ in range(2))
    return (src[:, :-1], tgt[:, :-1]), tgt[:, 1:]


def _make(dev, level):
    def make(cls):
        net = Seq2Seq(dev)
        return cls(net, CrossEntropyLoss(), Adam(
            learning_rate=1e-3, beta2=0.98, epsilon=1e-9,
            parameters=net.parameters()), amp_level=level)
    return make


def _run(step, inputs, labels, n):
    losses = torch.stack([step(inputs, labels) for _ in range(n)])
    return losses, {k: v.detach().clone()
                    for k, v in step.model.state_dict().items()}


@pytest.mark.parametrize("level", ["O0", "O1"])
def test_graphed_equals_eager_and_launches_the_kernels(level, dev):
    """Three graphed steps (a capture, then replays) equal three eager
    ones bit for bit; each replay adds the capture's launches: the flash
    forward, dK/dV and dQ once for each encoder self-attention and each
    cross-attention."""
    inputs, labels = _batch(dev)
    graphed = _make(dev, level)(TrainStep)
    for fn in FLASH:
        fn.launches = 0
    g_losses, g_state = _run(graphed, inputs, labels, 3)
    assert graphed.captures == 1 and graphed.replays == 2
    assert [fn.launches for fn in FLASH] == [3 * 2 * LAYERS] * 3
    for fn in FLASH:
        fn.launches = 0
    e_losses, e_state = _run(_make(dev, level)(EagerTrainStep), inputs,
                             labels, 3)
    assert [fn.launches for fn in FLASH] == [3 * 2 * LAYERS] * 3
    assert torch.isfinite(g_losses).all()
    assert torch.equal(g_losses, e_losses)
    for k in g_state:
        assert torch.equal(g_state[k], e_state[k]), k


def test_steps_make_no_blocking_sync(dev):
    """After the capture, graphed replays and eager steps run under
    ``set_sync_debug_mode("error")``: any blocking copy or sync raises."""
    inputs, labels = _batch(dev)
    graphed = _make(dev, "O1")(TrainStep)
    eager = _make(dev, "O1")(EagerTrainStep)
    graphed(inputs, labels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            graphed(inputs, labels)
            eager(inputs, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert graphed.replays == 2


class _Cell:
    """The decoder over (position, caches as plain tuples)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, inputs, states):
        pos, caches = states
        x = (inputs + self.model.pos_emb(pos))[:, None]
        named = [(MultiHeadAttention.Cache(*i),
                  MultiHeadAttention.StaticCache(*s)) for i, s in caches]
        out, named = self.model.transformer.decoder(x, None, cache=named)
        plain = tuple((tuple(i), tuple(s)) for i, s in named)
        return out[:, 0], (pos + 1, plain)


def _beam(model, src, steps=6):
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(model.src_emb, src))
        caches = tuple((tuple(i), tuple(s)) for i, s in
                       model.transformer.decoder.gen_cache(memory))
        inits = (torch.zeros(src.shape[0], dtype=torch.int64,
                             device=src.device), caches)
        decoder = BeamSearchDecoder(_Cell(model), 1, 2, 3,
                                    embedding_fn=model.tgt_emb,
                                    output_fn=model.out)
        return dynamic_decode(decoder, inits, max_step_num=steps,
                              return_length=True)


def test_beam_search_launches_the_flash_forward_and_equals_cpu(dev):
    card = Seq2Seq(dev).eval()
    cpu = Seq2Seq("cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    src = torch.randint(0, V, (2, 20),
                        generator=torch.Generator().manual_seed(6))
    fa.flash_attention_cuda.launches = 0
    ids, states, lengths = _beam(card, src.to(dev))
    steps = ids.shape[1]
    # the encoder's self-attentions, then each step's self- and
    # cross-attention a layer (one query row against the caches)
    assert fa.flash_attention_cuda.launches == LAYERS + 2 * LAYERS * steps
    want_ids, _, want_lengths = _beam(cpu, src)
    assert ids.shape == (2, steps, 3)
    assert torch.equal(ids.cpu(), want_ids)
    assert torch.equal(lengths.cpu(), want_lengths)
