"""Provenance ``meta`` block stamped into every ledger the port writes.

Port of ``repro.obs.provenance``: the ledger schema version, the torch and
CUDA versions, the device that executed the run (name and count), and the
repo git SHA when the tree is available. Everything here is information,
never gated.
"""

from __future__ import annotations

import os
import subprocess

# Version of the ledger envelope (the same envelope as the JAX package's).
SCHEMA_VERSION = 1


def git_sha(repo: str | None = None) -> str | None:
    """Short HEAD SHA of ``repo`` (default: this file's repo), or None."""
    if repo is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo, capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = r.stdout.strip()
    return sha if r.returncode == 0 and sha else None


def ledger_meta(device=None) -> dict:
    """The ``meta`` block: schema version + runtime + tree provenance.

    ``device`` is the device the run executed on (a ``torch.device`` or
    its name); the block names it, and for a CUDA device the card.
    """
    import torch

    dev = torch.device(device if device is not None else "cpu")
    meta = dict(
        schema_version=SCHEMA_VERSION,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        backend=dev.type,
    )
    if dev.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(dev)
        meta["device_count"] = torch.cuda.device_count()
    else:
        meta["device_name"] = "cpu"
        meta["device_count"] = 1
    sha = git_sha()
    if sha:
        meta["git_sha"] = sha
    return meta
