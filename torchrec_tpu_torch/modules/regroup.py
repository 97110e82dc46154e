"""KeyedTensor regrouping (``torchrec_tpu/modules/regroup.py``):
``KTRegroupAsDict`` names groups of keys of several KeyedTensors and
returns each group's columns concatenated (``KeyedTensor.regroup``; one
``torch.cat`` a group)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from torchrec_tpu_torch.sparse import KeyedTensor


class KTRegroupAsDict:
    """Callable: KeyedTensors -> ``{group name: [B, sum(group dims)]}``."""

    def __init__(self, groups: Sequence[Sequence[str]],
                 keys: Sequence[str]):
        if len(groups) != len(keys):
            raise ValueError(f"{len(groups)} groups for {len(keys)} names")
        self.groups = [list(g) for g in groups]
        self.keys = list(keys)

    def __call__(self, keyed_tensors: Sequence[KeyedTensor]
                 ) -> Dict[str, torch.Tensor]:
        return KeyedTensor.regroup_as_dict(keyed_tensors, self.groups,
                                           self.keys)
