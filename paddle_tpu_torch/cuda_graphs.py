"""CUDA-graph capture shared by the port's graphed steps: the serving
steps (``inference.paged.GraphedPagedDecoder``) and the training step
(``jit.TrainStep``)."""
import contextlib
import gc
import threading

import torch

# captures in flight (any thread) and whether the collector was on
# before the first of them: the last one to end turns it back on
_collector_lock = threading.Lock()
_captures_in_flight = 0
_collector_was_on = False


@contextlib.contextmanager
def _collector_off():
    """Python's cyclic collector off for the block, in every thread,
    for as long as any capture is in flight."""
    global _captures_in_flight, _collector_was_on
    with _collector_lock:
        if not _captures_in_flight:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _captures_in_flight += 1
    try:
        yield
    finally:
        with _collector_lock:
            _captures_in_flight -= 1
            if not _captures_in_flight and _collector_was_on:
                gc.enable()


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


def capture(graph, pool, stream, body, generators=()):
    """Capture ``body()`` into ``graph`` on ``stream`` (not the default
    stream: an autograd backward cannot be captured from it), drawing on
    ``pool``; ``thread_local`` capture errors, so the autograd engine's
    threads may launch into it.  Returns ``body``'s output and, per
    kernel wrapper, the launches a replay adds to its ``launches`` (the
    capture launched nothing, so its own counts are taken back).

    ``generators``: CUDA ``torch.Generator``s other than the device's
    default that ``body`` draws from (a MoE gate's random keep).  Each
    is registered with the graph before the capture
    (``register_generator_state``), so that every replay advances it and
    draws fresh numbers, as the default generator does; a draw from an
    unregistered one would be baked into the graph.

    A capture that fails raises, with the device's default random
    generator (and each of ``generators``) put back as it was: PyTorch
    would leave it marked as capturing, and every later random draw on
    the device would raise.

    Python's cyclic collector is off while the body is captured
    (``torch.cuda.graph`` collects once just before): a collection that
    the body's own allocations set off could free an unreachable graph
    of an earlier step or engine, and destroying a graph is a call the
    capturing thread may not make, so the capture would be invalidated."""
    wrappers = counted_wrappers()
    counts = [fn.launches for fn in wrappers]
    generator = torch.cuda.default_generators[stream.device.index]
    gens = [generator] + [g for g in dict.fromkeys(generators)
                          if g is not generator]
    states = [g.clone_state() for g in gens]
    for g in gens[1:]:
        graph.register_generator_state(g)
    try:
        with _collector_off(), torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            out = body()
    except BaseException:
        for g, state in zip(gens, states):
            g.graphsafe_set_state(state)
        raise
    finally:
        launches = {}
        for fn, n in zip(wrappers, counts):
            if fn.launches != n:
                launches[fn] = fn.launches - n
                fn.launches = n
    return out, launches
