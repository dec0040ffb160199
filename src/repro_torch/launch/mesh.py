"""Where the port runs: the device its entry points resolve to.

The JAX package builds a ``shards`` mesh over devices here; the port stacks
every shard on one card instead, so its counterpart is the choice of that
card. Entry points run on ``cuda`` unless the caller asks for the CPU; with
no GPU and no explicit CPU request they raise — nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; the port runs on the GPU unless the caller "
            "passes device='cpu' (CLI: --device cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    return dev
