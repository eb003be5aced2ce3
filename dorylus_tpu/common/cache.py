"""Persistent XLA compilation cache.

Compiling the training step is a large fixed cost of every run: a
Reddit-scale GCN or GAT group takes tens of seconds to compile. JAX's
persistent compilation cache serializes compiled executables keyed on the
HLO + compile options, so a program shape compiled once on a machine is
loaded, not compiled, by later processes there.

The reference has no analog (it is ahead-of-time C++), so compile latency
is a cost of this stack that we remove rather than a parity feature.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (and no
other directory is set in code), else one fixed directory inside the
checkout (`.jax_cache/`, gitignored). The path is part of the cache's
key, so a fixed path is what lets a later process hit. Enabled by default
from the engines, the CLI and bench.py; --compile-cache off disables it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled_path: Optional[str] = None


def enable_compile_cache(enabled: bool = True) -> Optional[str]:
    """Point JAX's persistent compilation cache at its directory
    (idempotent) and return it; enabled=False turns the cache off and
    returns None. Only compiles slower than 2 s are cached, so test-sized
    programs never churn the directory."""
    global _enabled_path
    import jax

    if not enabled:
        jax.config.update("jax_enable_compilation_cache", False)
        _enabled_path = None
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    if _enabled_path == path:
        return path
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    # Cache read/write failures must never fail a run.
    jax.config.update("jax_raise_persistent_cache_errors", False)
    _enabled_path = path
    return path
