"""Multi-dataset training pipeline (a copy of ``densereg_tpu/data/mixed.py``
over the port's input pipeline).

BASELINE.json config #5 names "Multi-dataset (ICVL+NYU+MSRA) training"; the
reference has no mechanism for it (one dataset per run).  This pipeline
interleaves several :class:`~densereg_torch.data.pipeline.InputPipeline`
streams with configurable mixture weights.  All member datasets must share
the joint count (the network heads are sized by it) — e.g. MSRA15 (21) with
BigHand (21), or several subjects/subsets of one dataset; ICVL(16)/NYU(14)/
MSRA(21) can be mixed after remapping annotations to a common skeleton,
which is the user's modelling decision, not the pipeline's.

With a ``mesh`` each member pipeline yields this rank's share of the batch
(``InputPipeline``'s multi-process form); every rank draws the same
sequence of members, since the mixture's generator is seeded alike on all.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from densereg_torch.data.base import DatasetSpec
from densereg_torch.data.pipeline import InputPipeline


class MixedPipeline:
    def __init__(self, specs: Sequence[DatasetSpec], batch_size: int,
                 sub_batch: int = 1, input_hw=(128, 128),
                 weights: Optional[Sequence[float]] = None, seed: int = 0,
                 mesh=None, device="cuda"):
        jnts = {s.jnt_num for s in specs}
        if len(jnts) != 1:
            raise ValueError(
                f"mixed training needs one joint count, got {sorted(jnts)}; "
                "remap annotations to a common skeleton first")
        self.specs = list(specs)
        w = np.asarray(weights if weights is not None
                       else [s.approximate_num for s in specs], np.float64)
        self.weights = w / w.sum()
        self._rng = np.random.default_rng(seed)
        self.pipelines = [
            InputPipeline(s, batch_size, sub_batch, input_hw,
                          seed=seed + 977 * i, mesh=mesh, device=device)
            for i, s in enumerate(specs)
        ]

    def __iter__(self) -> Iterator[dict]:
        iters = [iter(p) for p in self.pipelines]
        while True:
            i = int(self._rng.choice(len(iters), p=self.weights))
            yield next(iters[i])

    def close(self):
        for p in self.pipelines:
            p.close()
