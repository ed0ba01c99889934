"""ZeRO offload of optimizer state (``paddle_tpu_torch/distributed/
sharding.py``, ``optimizer.HostOffload``) on the CPU, against the JAX
package's ``group_sharded_parallel(..., offload=True)`` on its 8-device
CPU mesh — the cases of ``tests/test_sharding_stages.py:110-206``:

- the graphed path's ``TrainStep`` (on the CPU its eager twin) with
  offload equals the same step without offload bit for bit (losses,
  weights, state), and both are within relative 1e-5 of JAX's losses
  (f32; JAX shards the state over 8 devices and rounds its fused update
  its own way, observed ~1e-7);
- the eager ``loss.backward(); opt.step(); opt.clear_grad()`` path,
  likewise;
- bf16 parameters with f32 masters (``multi_precision``) and
  ``accumulate_steps=2``: offloaded equal to not offloaded bit for bit,
  the masters and state kept on the host; losses within relative 1e-2 of
  JAX's (bf16 products; the port feeds bf16 inputs where JAX promotes
  the f32 inputs to f32);
- groups: a parameter list is updated a bounded group at a time, and
  ``state_dict``/``set_state_dict`` keep writing the host tensors in
  place;
- the levels, one-rank only, and the comm-fusion warning.
Pinned host memory and the graph's captured copies need a card
(``tests/test_torch_fit_card.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim
from paddle_tpu.distributed import group_sharded_parallel as jax_gsp
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.distributed import sharding
from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.jit import TrainStep

D = 32


@pytest.fixture(autouse=True)
def _clean_topology():
    """JAX's group_sharded honors an ambient fleet topology: isolate these
    tests from mesh state other test files leave behind, so it shards
    over its default 8-device mesh."""
    from paddle_tpu.distributed.auto_parallel import process_mesh as pm
    from paddle_tpu.distributed.fleet import topology as topo
    saved = (pm._global_mesh, topo._hcg)
    pm._global_mesh = None
    topo._hcg = None
    yield
    pm._global_mesh, topo._hcg = saved


@pytest.fixture
def small_groups(monkeypatch):
    """Groups of at most 2000 elements: several a step at these sizes."""
    monkeypatch.setattr(sharding, "OFFLOAD_GROUP_NUMEL", 2000)


def _mse(o, lab):
    return ((o.float() - lab) ** 2).mean()


def _data(n=8):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((n, D)).astype(np.float32))


def _jax_model(bf16=False):
    paddle.seed(0)
    model = jnn.Sequential(jnn.Linear(D, 4 * D), jnn.GELU(),
                           jnn.Linear(4 * D, D))
    if bf16:
        for p in model.parameters():
            p._data = p._data.astype(jnp.bfloat16)
    return model


def _port_model(jm, bf16=False):
    """The JAX model's weights in the port (Linear weights transposed)."""
    model = torch.nn.Sequential(tnn.Linear(D, 4 * D, bias=True), tnn.GELU(),
                                tnn.Linear(4 * D, D, bias=True))
    with torch.no_grad():
        for (name, p), (_, jp) in zip(model.named_parameters(),
                                      jm.named_parameters()):
            a = np.array(jp._data.astype(jnp.float32))
            p.copy_(torch.from_numpy(a.T if name.endswith("weight") else a))
    return model.to(torch.bfloat16) if bf16 else model


def _port_run(offload, mode, steps, bf16=False, accumulate=1):
    jm = _jax_model(bf16)
    model = _port_model(jm, bf16)
    opt = toptim.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                       multi_precision=bf16)
    model, opt, _ = group_sharded_parallel(model, opt, "os_g",
                                           offload=offload)
    x, y = (torch.from_numpy(a) for a in _data())
    if bf16:
        x = x.to(torch.bfloat16)   # JAX promotes to f32 here; the port's
        #                            Linear takes one type
    losses = []
    if mode == "train_step":
        step = TrainStep(model, _mse, opt, accumulate_steps=accumulate)
        for _ in range(steps):
            losses.append(step(x, y))
    else:
        for _ in range(steps):
            loss = _mse(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
    return torch.stack(losses), model, opt


def _jax_run(offload, mode, steps, bf16=False, accumulate=1):
    model = _jax_model(bf16)
    opt = joptim.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                       multi_precision=bf16)
    model, opt, _ = jax_gsp(model, opt, "os_g", offload=offload)
    x, y = (paddle.to_tensor(a) for a in _data())
    loss_fn = lambda o, lab: ((o.astype("float32") - lab) ** 2).mean()  # noqa: E731
    losses = []
    if mode == "train_step":
        step = JaxTrainStep(model, loss_fn, opt,
                            accumulate_steps=accumulate)
        for _ in range(steps):
            losses.append(float(step(x, y).numpy()))
    else:
        for _ in range(steps):
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
    return np.asarray(losses)


def _state(opt):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in opt.state_dict().items()}


def _assert_same_run(a, b):
    (la, ma, oa), (lb, mb, ob) = a, b
    assert torch.equal(la, lb)
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        assert torch.equal(pa, pb)
    sa, sb = _state(oa), _state(ob)
    assert sa.keys() == sb.keys()
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k


@pytest.mark.parametrize("mode", ["train_step", "eager_step"])
def test_offload_equals_no_offload_and_jax(mode, small_groups):
    off = _port_run(True, mode, 4)
    _assert_same_run(off, _port_run(False, mode, 4))
    opt = off[2]
    homes = [t for acc in opt._accumulators.values() for t in acc.values()]
    assert homes and all(t.device.type == "cpu" for t in homes)
    np.testing.assert_allclose(off[0].numpy(), _jax_run(True, mode, 4),
                               rtol=1e-5)


def test_offload_with_accumulation_and_masters(small_groups):
    off = _port_run(True, "train_step", 4, bf16=True, accumulate=2)
    _assert_same_run(off, _port_run(False, "train_step", 4, bf16=True,
                                    accumulate=2))
    opt = off[2]
    masters = list(opt._master_weights.values())
    assert len(masters) == 4
    assert all(m.dtype == torch.float32 and m.device.type == "cpu"
               for m in masters)
    assert opt._global_step == 2
    np.testing.assert_allclose(
        off[0].numpy(),
        _jax_run(True, "train_step", 4, bf16=True, accumulate=2),
        rtol=1e-2)


def test_groups_are_bounded_and_in_order():
    off = toptim.optimizer.HostOffload(group_numel=100)
    params = [torch.zeros(n) for n in (30, 50, 40, 300, 10, 10)]
    assert list(off.groups(params)) == [(0, 2), (2, 3), (3, 4), (4, 6)]
    assert list(off.groups([])) == []


def test_state_dict_round_trip_writes_host_state_in_place(small_groups):
    _, model, opt = _port_run(True, "eager_step", 2)
    homes = {id(t) for acc in opt._accumulators.values()
             for t in acc.values()}
    sd = _state(opt)
    _port_run(True, "eager_step", 1)      # another run, other state
    opt.set_state_dict({k: (v + 1 if isinstance(v, torch.Tensor) else v)
                        for k, v in sd.items()})
    assert homes == {id(t) for acc in opt._accumulators.values()
                     for t in acc.values()}
    back = _state(opt)
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(back[k], v + 1), k


def test_levels_and_world():
    model = torch.nn.Sequential(tnn.Linear(4, 4))
    for level in ("os", "os_g", "p_g_os"):
        opt = toptim.SGD(learning_rate=0.1, parameters=model.parameters())
        m, o, s = group_sharded_parallel(model, opt, level)
        assert m is model and o is opt and s is None
        assert o._offload is None
    opt = toptim.SGD(learning_rate=0.1, parameters=model.parameters())
    with pytest.raises(ValueError):
        group_sharded_parallel(model, opt, "zero9")
    with pytest.raises(NotImplementedError):
        group_sharded_parallel(model, opt, "os", degree=2)
    with pytest.warns(UserWarning, match="comm-fusion"):
        group_sharded_parallel(model, opt, "os_g", buffer_max_size=1 << 20)
