"""CUDA-graph capture shared by the port's graphed steps: the serving
steps (``inference.paged.GraphedPagedDecoder``) and the training step
(``jit.TrainStep``)."""
import torch


def counted_wrappers():
    """Every kernel wrapper that counts its launches (``.launches``)."""
    from .ops import (flash_attention, flashmask_attention, fused_norm_rope,
                      moe_gating, paged_attention, quant_matmul)
    return list(dict.fromkeys(
        fn for mod in (flash_attention, flashmask_attention,
                       fused_norm_rope, moe_gating, paged_attention,
                       quant_matmul)
        for fn in vars(mod).values()
        if callable(fn) and hasattr(fn, "launches")))


def capture(graph, pool, stream, body):
    """Capture ``body()`` into ``graph`` on ``stream`` (not the default
    stream: an autograd backward cannot be captured from it), drawing on
    ``pool``; ``thread_local`` capture errors, so the autograd engine's
    threads may launch into it.  Returns ``body``'s output and, per
    kernel wrapper, the launches a replay adds to its ``launches`` (the
    capture launched nothing, so its own counts are taken back).

    A capture that fails raises, with the device's default random
    generator put back as it was: PyTorch would leave it marked as
    capturing, and every later random draw on the device would raise."""
    wrappers = counted_wrappers()
    counts = [fn.launches for fn in wrappers]
    generator = torch.cuda.default_generators[stream.device.index]
    rng = generator.clone_state()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
    except BaseException:
        generator.graphsafe_set_state(rng)
        raise
    finally:
        launches = {}
        for fn, n in zip(wrappers, counts):
            if fn.launches != n:
                launches[fn] = fn.launches - n
                fn.launches = n
    return out, launches
