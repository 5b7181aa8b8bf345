"""The closed-loop generator: `clients` clients, each sending its next
request as soon as its previous one completes.

Every seed gets the same set of sizes: a size distribution is cut into
`block` equal-probability strata, and the requests take the strata's
midpoints in blocks, each block a permutation of the whole set drawn from
the seed. So two seeds differ in order and content, never in the mix of
sizes, and any stretch of requests longer than a block or two holds the
mix's proportions.

A mix of this kind holds:
  clients     the number of clients;
  block       strata a block (the permutation's length);
  sizes       {name: {"dist": "uniform" | "loguniform", "lo", "hi"}}: the
              per-request sizes, each stratified and permuted on its own;
  the rest    parameters that the cell's entry (portbench/entries) reads.
"""
from __future__ import annotations

import numpy as np

from portbench.harness.traffic import strata


class Requests:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 0x7ea])
        self.block = int(mix["block"])
        self.values = {k: strata(d, self.block) for k, d in mix["sizes"].items()}
        self.queue: list = []
        self.index = 0

    def _refill(self):
        perms = {k: self.rng.permutation(v) for k, v in self.values.items()}
        seeds = self.rng.integers(1, 2**62, self.block)
        for i in range(self.block):
            self.queue.append(dict({k: float(p[i]) for k, p in perms.items()},
                                   seed=int(seeds[i])))

    def next(self) -> dict:
        if not self.queue:
            self._refill()
        req = self.queue.pop(0)
        req.update(index=self.index, at=None)
        self.index += 1
        return req
