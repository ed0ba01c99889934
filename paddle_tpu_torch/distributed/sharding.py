"""Group-sharded (ZeRO) training (port of
paddle_tpu/distributed/fleet/sharding.py): ``group_sharded_parallel``
and ``save_group_sharded_model``.

On one rank the levels ``os`` (stage 1), ``os_g`` (stage 2) and
``p_g_os`` (stage 3) shard nothing, as the JAX package's do on one
device; a world of more than one rank raises until data parallelism is
ported.  ``offload=True`` keeps every optimizer state slot and every f32
master weight in host memory between steps, pinned when the parameters
live on a card (``optimizer.optimizer.HostOffload``): the update copies a
bounded group of parameters' state to the device at a time, runs the
same rule and copies it back, so the weights equal a run without
offload bit for bit while the device holds one group's state.
"""
from __future__ import annotations

import warnings

from ..framework.io import save
from ..optimizer.optimizer import HostOffload

#: elements of the parameters whose state one offloaded group holds (a
#: larger parameter is a group of its own)
OFFLOAD_GROUP_NUMEL = 1 << 26


def _world_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None, degree=None):
    """The reference's ``paddle.distributed.sharding.group_sharded_parallel``.

    ``level``: 'os' | 'os_g' | 'p_g_os'.  Returns ``(model, optimizer,
    scaler)``, the optimizer set to keep its state in host memory when
    ``offload``.  Call it before the optimizer has made any state (before
    its first step and before a ``TrainStep`` is built on it)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be os|os_g|p_g_os, got {level}")
    if buffer_max_size is not None or segment_size is not None or sync_comm:
        warnings.warn(
            "buffer_max_size/segment_size/sync_comm are comm-fusion knobs "
            "of the reference's hand-written NCCL path; on one rank there "
            "is no collective to fuse, so these arguments have no effect "
            "here", stacklevel=2)
    world = _world_size() if group is None else group.size()
    if world > 1 or (degree is not None and degree > 1):
        raise NotImplementedError(
            f"group_sharded_parallel over {max(world, degree or 1)} ranks: "
            "the port shards over one rank only until data parallelism "
            "is ported")
    if offload:
        if optimizer._accumulators or optimizer._master_weights:
            raise RuntimeError("offload must be set before the optimizer "
                               "has made its state")
        optimizer._offload = HostOffload(OFFLOAD_GROUP_NUMEL)
    optimizer._sharding_level = level
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """``output.pdmodel`` (the model's state) and ``output.pdopt`` (the
    optimizer's), in the format of ``framework.io.save``."""
    save(model.state_dict(), output + ".pdmodel")
    if optimizer is not None:
        save(optimizer.state_dict(), output + ".pdopt")
