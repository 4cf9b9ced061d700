"""The env half of a captured control step, checked on the CPU.

On the card an episode replays one control step captured as a CUDA graph
(harness/episode.py), the real env step included; a capture fails if the
step copies anything from the host, as a tensor made from a host array or
list, a Python list used as an index or a scalar written into a slice
through an index does. Here every registered env's step, observation and
success run once to warm their caches, then once more under a dispatch
mode that records every operation: no operand may be a tensor that
neither existed before the step nor came out of an earlier operation of
it (a tensor made from host data). The replay itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's episode_replay phase).
"""
import gc

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mjmpc_tpu_torch import envs

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
# operations that write an operand into device memory: a 0-d host operand
# counts there (elsewhere a 0-d host scalar is passed by value)
_WRITES = {"copy_", "index_put_", "index_put", "_index_put_impl_", "lift_fresh",
           "lift_fresh_copy"}


def _ptr(t):
    try:
        return t.untyped_storage().data_ptr() if t.numel() else None
    except (NotImplementedError, RuntimeError):   # a torch.func wrapper
        return None


class _HostTensors(TorchDispatchMode):
    """Records the operations that take a tensor made from host data."""

    def __init__(self, known):
        super().__init__()
        self.known, self.hits = set(known), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        for a in tree_flatten((args, kwargs or {}))[0]:
            if isinstance(a, torch.Tensor):
                p = _ptr(a)
                if p is not None and p not in self.known and (a.dim() > 0 or name in _WRITES):
                    self.hits.append((str(func), tuple(a.shape)))
        out = func(*args, **(kwargs or {}))
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and _ptr(o) is not None:
                self.known.add(_ptr(o))
        return out


def _live_storages():
    out = set()
    for t in gc.get_objects():
        if isinstance(t, torch.Tensor):
            out.add(_ptr(t))
    return out - {None}


@pytest.mark.parametrize("name", envs.available())
def test_env_step_makes_no_tensor_from_host_data(name):
    env = envs.make(name, device=DEVICE)
    state = env.init(env.params, 0)
    action = torch.full((env.d_action,), 0.3)

    def run():
        nxt, *_ = env.step(env.params, state, action)
        env.observe(env.params, nxt)
        if env.success is not None:
            env.success(env.params, nxt)

    run()   # lazy caches (the engine's masks) are made here
    mode = _HostTensors(_live_storages())
    with mode:
        run()
    assert not mode.hits, f"{name}: operations on tensors made from host data: {mode.hits}"
