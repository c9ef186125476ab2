"""stderr logging with file:line prefixes — the log.hpp analog.

The reference's entire logging system is a macro printing ``[file:line]`` to
stderr (cuda_simulator/src/lib/log.hpp:3-8). Same surface here, plus level
filtering via the PS_TPU_LOG env var (debug|info|warn|error, default info).
The port's own copy of ``particle_simulator_tpu/utils/log.py``; the variable
keeps its name, so a user's setting carries over. ``report_foreign_modules``
is the port's own: each entry point names, as it exits, any module of jax or
of the JAX package it imported.
"""

from __future__ import annotations

import inspect
import os
import sys

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_THRESHOLD = _LEVELS.get(os.environ.get("PS_TPU_LOG", "info").lower(), 20)


def _emit(level: str, *args) -> None:
    if _LEVELS[level] < _THRESHOLD:
        return
    frame = inspect.stack()[2]
    loc = f"{os.path.basename(frame.filename)}:{frame.lineno}"
    print(f"[{loc}]", *args, file=sys.stderr)


def debug(*args) -> None:
    _emit("debug", *args)


def log(*args) -> None:
    """info-level, the reference macro's name."""
    _emit("info", *args)


def warn(*args) -> None:
    _emit("warn", *args)


def error(*args) -> None:
    _emit("error", *args)


def foreign_modules() -> list[str]:
    """The modules of ``jax`` or of the JAX package this process has
    imported: none, since the port stands alone."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "particle_simulator_tpu"))


FOREIGN_MODULES_TAG = "foreign modules "


def report_foreign_modules(who: str) -> None:
    """One stderr line, ``<who>: foreign modules [...]`` (a JSON list of
    ``foreign_modules()``): an entry point prints it as it exits, so that
    whoever started the process can check that nothing of jax or the JAX
    package came in."""
    import json

    print(f"{who}: {FOREIGN_MODULES_TAG}{json.dumps(foreign_modules())}", file=sys.stderr,
          flush=True)
