"""Persistent tuning cache + matrix fingerprinting (port of
``repro.autotune.cache``).

A tuning decision is a property of (problem, partitioning, objective,
model), so the cache key hashes all four:

* the **matrix fingerprint** — cheap host statistics that identify a
  problem without hashing its values: n, nnz, row-nnz quantiles
  (0/25/50/75/100%), bandwidth (max |i − j| over the pattern), the shard
  count, the objective and ``nrhs``; the dict is the JAX package's, key for
  key, so the ledgers' ``autotune.fingerprint`` sections agree;
* the **model hash** — every parameter of the :class:`CostModel` chain
  (PowerModel → ChipSpec/HostSpec, the chip's name, the DVFS grid
  ``freq_points`` and ``v_floor`` included) plus the cache :data:`SCHEMA`
  version. The chip is part of the key through it: an entry tuned with
  the H100 model and one tuned with another chip's never collide, even in
  one file. Recalibrating the power model, changing the frequency grid or
  bumping the schema makes every stale entry unfindable.

Entries store the chosen candidate plus the fingerprint/model context for
debugging; lookups recompute the key and never trust stored context.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from repro_torch.autotune.space import Candidate
from repro_torch.energy.accounting import CostModel

#: Cache entry schema version. Bump on any change to the entry layout or to
#: the meaning of the fingerprint/key: old files keep working, their entries
#: just stop matching. v2: the fingerprint carries ``nrhs``.
SCHEMA = 2

#: Default on-disk location, relative to the process's working directory
#: (the repo root for ``launch.solve``).
DEFAULT_PATH = os.path.join("runs", "autotune", "cache.json")

_QUANTILES = (0.0, 0.25, 0.5, 0.75, 1.0)


def fingerprint(a_csr, n_shards: int, objective: str, *,
                nrhs: int = 1) -> dict:
    """Cheap, stable identity of one tuning problem (see module doc).

    ``nrhs`` is part of the identity: a decision tuned for a single-RHS
    solve must never be served to a batched solve whose matrix traffic is
    amortized r ways."""
    a = a_csr.tocsr()
    row_nnz = np.diff(a.indptr)
    if row_nnz.size:
        q = [int(v) for v in np.quantile(row_nnz, _QUANTILES)]
    else:
        q = [0] * len(_QUANTILES)
    coo = a.tocoo()
    bandwidth = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0
    return dict(
        n=int(a.shape[0]),
        nnz=int(a.nnz),
        row_nnz_q=q,
        bandwidth=bandwidth,
        shards=int(n_shards),
        objective=str(objective),
        nrhs=int(nrhs),
    )


def model_hash(cost: CostModel) -> str:
    """Hash of every cost/power/chip parameter (the DVFS grid and the
    chip's name included)."""
    params = dataclasses.astuple(cost)  # recurses into PowerModel/ChipSpec
    return hashlib.sha1(repr(params).encode()).hexdigest()[:16]


class TuneCache:
    """JSON-file cache of tuning decisions (``runs/autotune/cache.json``)."""

    def __init__(self, path: str = DEFAULT_PATH):
        self.path = path

    def key(self, fp: dict, cost: CostModel) -> str:
        payload = dict(schema=SCHEMA, fingerprint=fp, model=model_hash(cost))
        return hashlib.sha1(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()

    def _load(self) -> dict:
        """The file's contents; a missing or corrupt file reads as empty."""
        empty = {"schema": SCHEMA, "entries": {}}
        if not os.path.exists(self.path):
            return empty
        try:
            with open(self.path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return empty
        if not isinstance(d, dict) or not isinstance(d.get("entries"), dict):
            return empty
        return d

    def get(self, fp: dict, cost: CostModel) -> Candidate | None:
        """The cached choice for this (problem, objective, model), if any."""
        entry = self._load()["entries"].get(self.key(fp, cost))
        if not entry or entry.get("schema") != SCHEMA:
            return None
        try:
            return Candidate.from_dict(entry["chosen"])
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, fp: dict, cost: CostModel, chosen: Candidate,
            extra: dict | None = None) -> str:
        """Persist a decision; returns the entry key. The write is atomic
        (a temporary file renamed over the cache)."""
        d = self._load()
        k = self.key(fp, cost)
        d["schema"] = SCHEMA
        d["entries"][k] = dict(
            schema=SCHEMA,
            chosen=chosen.to_dict(),
            fingerprint=fp,
            model=model_hash(cost),
            **(extra or {}),
        )
        dirname = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(dirname, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        return k
