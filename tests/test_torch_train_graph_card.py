"""The graphed training step on the card against the eager one
(``EagerTrainStep``, the same body without graphs), on a small LLaMA
whose attention, RMSNorm and RoPE run the port's kernels.  These need a
CUDA device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_train_graph_card.py

Graphed and eager run the same kernels in the same order on the same
inputs, so losses and parameters are held bit for bit."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.cuda_graphs import counted_wrappers
from paddle_tpu_torch.inference import paged
from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

pytestmark = pytest.mark.cuda

VOCAB = 256
CFG = dict(vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
KERNELS = ("flash_attention_cuda", "flash_attention_bwd_dkv_cuda",
           "flash_attention_bwd_dq_cuda", "rms_norm_triton",
           "apply_rope_triton")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _loss(logits, labels):
    return TF.cross_entropy(logits.reshape(-1, VOCAB).float(),
                            labels.reshape(-1))


def _batches(n, seqs=(128,), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [tuple(torch.randint(0, VOCAB, (2, seqs[i % len(seqs)]),
                                generator=g).cuda() for _ in range(2))
            for i in range(n)]


def _warmup_cosine():
    return toptim.lr.LinearWarmup(
        toptim.lr.CosineAnnealingDecay(2e-3, T_max=6), warmup_steps=2,
        start_lr=0.0, end_lr=2e-3)


def _stepper(cls, dtype, accumulate=1, clip=False, lr=1e-3):
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", dtype=dtype,
                             seed=3)
    opt = toptim.AdamW(learning_rate=lr, parameters=model.parameters(),
                       multi_precision=dtype == torch.bfloat16,
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0) if clip
                       else None)
    return cls(model, _loss, opt, accumulate_steps=accumulate)


def _same_params(a, b):
    for (name, x), y in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("accumulate,clip", [(1, False), (2, True)])
def test_graph_steps_equal_eager_steps(dev, dt, accumulate, clip):
    batches = _batches(6)
    runs = []
    for cls in (TrainStep, EagerTrainStep):
        step = _stepper(cls, DTYPES[dt], accumulate, clip)
        runs.append((step, torch.stack([step(i, l) for i, l in batches])))
    (graphed, g_losses), (eager, e_losses) = runs
    # one key a call kind: accumulating and applying are two graphs
    assert graphed.captures == accumulate
    assert graphed.replays == len(batches) - accumulate
    assert torch.isfinite(g_losses).all()
    assert torch.equal(g_losses, e_losses)
    _same_params(graphed, eager)


def test_graph_captures_one_graph_a_key(dev):
    step = _stepper(TrainStep, torch.bfloat16)
    for i, l in _batches(6, seqs=(64, 128)):
        loss = step(i, l)
    assert torch.isfinite(loss)
    assert (step.captures, step.replays) == (2, 4)


def test_graph_replays_advance_launch_counters(dev):
    """A replay adds its capture's launches: the five kernels of the
    training path count as many launches a replayed step as an eager
    one."""
    wrappers = {fn.__name__: fn for fn in counted_wrappers()}
    batches = _batches(4)
    per_step = []
    for cls in (EagerTrainStep, TrainStep):
        step = _stepper(cls, torch.bfloat16)
        step(*batches[0])
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for i, l in batches[1:]:
            step(i, l)
        per_step.append({n: fn.launches / 3 for n, fn in wrappers.items()})
    assert per_step[0] == per_step[1]
    assert all(per_step[1][n] > 0 for n in KERNELS), per_step[1]


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_graph_run_steps_equal_single_calls(dev, schedule):
    batches = _batches(5, seed=1)
    runs = []
    for fused in (True, False):
        sched = _warmup_cosine() if schedule == "warmup_cosine" else None
        step = _stepper(TrainStep, torch.bfloat16,
                        lr=sched if sched is not None else 1e-3)
        assert step.fused_supported
        if fused:
            losses = step.run_steps(batches)
        else:
            losses = []
            for i, l in batches:
                losses.append(step(i, l))
                if sched is not None:
                    sched.step()
            losses = torch.stack(losses)
        runs.append((step, losses))
    assert torch.equal(runs[0][1], runs[1][1])
    _same_params(runs[0][0], runs[1][0])
    assert runs[0][0].optimizer._global_step == len(batches)


def test_failed_capture_raises(dev):
    """No fallback: a body that reads a device value back to the host runs
    eagerly on its first call and then fails to capture, which raises."""

    def host_read_loss(logits, labels):
        loss = _loss(logits, labels)
        return loss * (1.0 if loss.item() > 0 else 0.0)

    step = _stepper(TrainStep, torch.float32)
    step.loss_fn = host_read_loss
    with pytest.raises(RuntimeError):
        step(*_batches(1)[0])
    assert step.captures == 0
    # the default generator is left usable (PyTorch leaves it marked as
    # capturing after a failed capture)
    assert torch.randn(4, device=dev).isfinite().all()


def test_failed_decoder_capture_leaves_the_generator_usable(dev):
    """The serving graphs share the capture: after a failed one, random
    draws on the device still work."""
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda",
                             dtype=torch.bfloat16, seed=3).eval()
    cache = PagedKVCache.from_model(model, total_pages=32, page_size=16)
    dec = paged.GraphedPagedDecoder(model)
    def read_back(mod, args, out):
        float(out.float().sum())

    hook = model.model.norm.register_forward_hook(read_back)
    try:
        with pytest.raises(RuntimeError):
            dec.prefill(cache, [0], np.arange(5, dtype=np.int32)[None])
    finally:
        hook.remove()
    assert dec.captures == 0
    assert torch.randn(4, device=dev).isfinite().all()
