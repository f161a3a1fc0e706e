"""Dense record batches: the unit a map task stages onto the device.

Counterpart of ``DenseBatch`` in ``tpumr/io/recordbatch.py:175-205``.
``values`` is a host numpy array as the input format reads it, or a torch
tensor once the runner has staged it onto the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class DenseBatch:
    """Dense numeric records ``[n, d]`` (+ optional int64 record ids)."""

    values: Any                              # [n, d] np.ndarray or tensor
    ids: "np.ndarray | None" = None          # [n] int64 record ids
    meta: dict = field(default_factory=dict)

    @property
    def num_records(self) -> int:
        return int(self.values.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.values.nbytes
                   + (self.ids.nbytes if self.ids is not None else 0))
