"""The port's watchdog (``paddle_tpu_torch.distributed.watchdog``), the
heartbeat half of the JAX package's ``CommTaskManager``: scanned with
``scan_once`` on a private manager, so nothing depends on the scan
thread's timing."""
import warnings

import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

from paddle_tpu_torch.distributed import CommTaskManager
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM


class Probe:
    """An age the test sets, and the reactions it got."""

    def __init__(self):
        self.age = None
        self.fired = 0

    def __call__(self):
        return self.age

    def react(self):
        self.fired += 1


def scan(mgr):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        mgr.scan_once()
    return [str(w.message) for w in seen]


def test_one_reaction_an_excursion_rearmed_once_healthy():
    mgr = CommTaskManager()
    probe = Probe()
    mgr.register_heartbeat("engine/decode_step", probe, 0.25,
                           on_timeout=probe.react)
    assert scan(mgr) == [] and probe.fired == 0      # idle
    probe.age = 0.1
    assert scan(mgr) == [] and probe.fired == 0      # in flight, in time
    probe.age = 0.3
    msgs = scan(mgr)
    assert probe.fired == 1 and mgr.timeouts == 1
    assert len(msgs) == 1 and "engine/decode_step" in msgs[0]
    probe.age = 0.9
    assert scan(mgr) == [] and probe.fired == 1      # same excursion
    probe.age = None
    scan(mgr)                                        # healthy: re-armed
    probe.age = 0.5
    scan(mgr)
    assert probe.fired == 2 and mgr.timeouts == 2


def test_a_raising_probe_does_not_stop_the_scan():
    mgr = CommTaskManager()

    def broken():
        raise RuntimeError("probe failed")

    def broken_reaction():
        raise RuntimeError("reaction failed")

    probe = Probe()
    probe.age = 5.0
    mgr.register_heartbeat("broken", broken, 0.25)
    mgr.register_heartbeat("wedged", lambda: 5.0, 0.25,
                           on_timeout=broken_reaction)
    mgr.register_heartbeat("probe", probe, 0.25, on_timeout=probe.react)
    msgs = scan(mgr)
    assert probe.fired == 1 and mgr.timeouts == 2
    assert sorted(m.split("'")[1] for m in msgs) == ["probe", "wedged"]


def test_unregister_leaves_no_name_behind():
    mgr = CommTaskManager()
    probe = Probe()
    probe.age = 1.0
    hid = mgr.register_heartbeat("a", probe, 0.25, on_timeout=probe.react)
    mgr.register_heartbeat("b", lambda: None, 0.25)
    assert mgr.heartbeat_names() == ["a", "b"]
    mgr.unregister_heartbeat(hid)
    mgr.unregister_heartbeat(hid)                    # twice: a no-op
    assert mgr.heartbeat_names() == ["b"]
    scan(mgr)
    assert probe.fired == 0 and mgr.timeouts == 0


def test_the_scan_thread_starts_and_stops():
    mgr = CommTaskManager(scan_interval=0.01)
    probe = Probe()
    probe.age = 1.0
    mgr.register_heartbeat("t", probe, 0.25, on_timeout=probe.react)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mgr.start()
        mgr.start()                                  # already running
        for _ in range(500):
            if probe.fired:
                break
            mgr._stop.wait(0.01)
        mgr.stop()
    assert probe.fired == 1 and mgr._thread is None
    assert CommTaskManager.instance() is CommTaskManager.instance()


@pytest.mark.parametrize("timeout", [None, 30.0], ids=["off", "on"])
def test_engine_stop_unregisters_its_heartbeat(timeout):
    mgr = CommTaskManager.instance()
    before = mgr.heartbeat_names().count("engine/decode_step")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64), device="cpu", seed=0)
    eng = ContinuousBatchingEngine(model, total_pages=16, page_size=8,
                                   step_timeout_s=timeout, device="cpu")
    try:
        assert mgr.heartbeat_names().count("engine/decode_step") \
            == before + (timeout is not None)
        eng.submit([1, 2, 3], max_new_tokens=3).result(timeout=60)
        assert eng._step_age() is None              # idle between steps
    finally:
        eng.stop()
        mgr.stop()
    assert mgr.heartbeat_names().count("engine/decode_step") == before
