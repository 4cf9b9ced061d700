"""Small structural helpers (counterpart of mjmpc_tpu/utils/helpers.py,
reference mjmpc/utils/helpers.py:101-116), on tensors and numpy arrays."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch


def stack_tensor_list(tensor_list: Sequence):
    """Stack a list along a new first axis: torch.stack when the entries
    are tensors (on their device), np.stack of np.asarray otherwise."""
    if isinstance(tensor_list[0], torch.Tensor):
        return torch.stack(list(tensor_list))
    return np.stack([np.asarray(t) for t in tensor_list])


def stack_tensor_dict_list(tensor_dict_list: Sequence[Dict]) -> Dict:
    """A list of (possibly nested) dicts -> a dict of stacked entries."""
    out: Dict[str, Any] = {}
    for k, example in tensor_dict_list[0].items():
        entries = [d[k] for d in tensor_dict_list]
        out[k] = (stack_tensor_dict_list(entries) if isinstance(example, dict)
                  else stack_tensor_list(entries))
    return out
