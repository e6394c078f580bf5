"""The full-RD intra encoder with its mode search in PyTorch.

IntraEncoder subclasses svt_av1_psy_tpu.models.intra_encoder.IntraEncoder
and overrides only _decide, the one method that calls JAX: the open-loop
mode costs of every block size run on ``self.device`` (the port's
block_mode_costs) and come home through one HostCopy per size. The split
tree over those costs, the palette and intra-block-copy searches, the RD
commit and the bitstream are the reference's host code, unchanged;
tests/test_torch_intra_encoder.py guards the copied split tree against
drift.

The API routes presets <= 3 and --scm 1 here, and the fast encoder's
screen-content key frames (models/fast_intra.py _encode_key_sc).
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_psy_tpu.models import intra_encoder
from svt_av1_psy_tpu.ops.quant import ac_q
from svt_av1_psy_tpu_torch.ops.torch_backend import (block_mode_costs,
                                                     plane_tensor)
from svt_av1_psy_tpu_torch.utils.device import HostCopy, resolve_device


class IntraEncoder(intra_encoder.IntraEncoder):
    """Full-RD intra encoder with the mode search in PyTorch on ``device``
    ("cpu" or "cuda[:N]")."""

    def __init__(self, *args, device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    def _decide(self, yp: np.ndarray):
        """Per size: the cheapest mode's cost and the first cheapest mode
        of every block (block_mode_costs on the device, its min over
        modes taken there), then the reference's bottom-up split tree on
        the host."""
        sizes = [s for s in (64, 32, 16, 8) if s >= self.min_block]
        costs = {}
        bests = {}
        arr = plane_tensor(yp, self.device)
        copies = {}
        for s in sizes:
            c, b = block_mode_costs(arr, s, self.bd)
            copies[s] = HostCopy(torch.stack([c.amin(dim=2), b]))
        for s in sizes:
            cost_best = copies[s].numpy()
            costs[s] = cost_best[0].astype(np.int64)
            bests[s] = cost_best[1]
        bias = 8 * ac_q(self.qindex, self.bd)
        split = {}
        eff = {sizes[-1]: costs[sizes[-1]]}
        for s in sizes[-2::-1]:
            child = eff[s // 2]
            agg = (child[0::2, 0::2] + child[0::2, 1::2] +
                   child[1::2, 0::2] + child[1::2, 1::2])
            do_split = agg + bias < costs[s]
            split[s] = do_split
            eff[s] = np.where(do_split, agg + bias, costs[s])
        return bests, split
