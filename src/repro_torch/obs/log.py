"""Structured logging for the launchers (``--log-level`` / ``REPRO_LOG``).

The repo's CLI output is a *contract*: benchmark parsers and the pinned
stdout tests consume exact lines. So the default configuration renders
messages bare (``%(message)s``) on **stdout** at INFO — byte-identical to
the ``print`` calls it replaces — while ``--log-level debug`` (or
``REPRO_LOG=debug``) switches the whole ``repro_torch`` logger family to a
prefixed diagnostic format and unlocks the debug chatter, and
``--log-level warning`` silences progress output entirely without touching
the code that emits it.

Usage::

    from repro_torch.obs import log as olog
    LOG = olog.get_logger("serve")        # the "repro_torch.serve" logger
    LOG.info("served %d requests", n)     # contract line: stays bare
    LOG.debug("flush: %d queued", depth)  # visible only at debug level

``setup`` is idempotent per process; the first ``get_logger`` call
configures from the environment, an explicit ``setup(level=...)`` (the
``--log-level`` flag) reconfigures.
"""

from __future__ import annotations

import logging
import os
import sys

LEVELS = ("debug", "info", "warning", "error")

_BARE_FORMAT = "%(message)s"
_DEBUG_FORMAT = "[%(levelname).1s %(name)s] %(message)s"

_configured = False


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that resolves ``sys.stdout`` at emit time.

    Binding the stream at setup time would freeze whatever object
    ``sys.stdout`` was then — breaking capture-based tests (pytest swaps
    the stream per test) and any caller that redirects stdout after the
    first ``get_logger``.
    """

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):  # the base __init__/setStream assign it
        pass


def setup(level: str | None = None) -> logging.Logger:
    """Configure the root ``repro_torch`` logger (idempotent unless ``level``).

    ``level`` wins over ``REPRO_LOG``; both default to ``info``. At
    ``info`` the handler writes bare messages to stdout — exactly what the
    historical ``print`` calls produced.
    """
    global _configured
    root = logging.getLogger("repro_torch")
    if _configured and level is None:
        return root
    name = (level or os.environ.get("REPRO_LOG") or "info").lower()
    if name not in LEVELS:
        raise ValueError(
            f"unknown log level {name!r} (choose from {', '.join(LEVELS)})"
        )
    root.setLevel(getattr(logging, name.upper()))
    root.propagate = False
    fmt = _DEBUG_FORMAT if name == "debug" else _BARE_FORMAT
    if root.handlers:
        for h in root.handlers:
            h.setFormatter(logging.Formatter(fmt))
    else:
        h = _StdoutHandler()
        h.setFormatter(logging.Formatter(fmt))
        root.addHandler(h)
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    """The ``repro_torch[.name]`` logger, configuring defaults on first use."""
    setup()
    return logging.getLogger(f"repro_torch.{name}" if name else "repro_torch")
