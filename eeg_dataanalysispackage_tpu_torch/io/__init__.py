"""Input: BrainVision parsing, the offline data provider, model files,
and the local and remote filesystems they read through.

``EEG_TPU_PREFETCH_DEPTH`` is one knob for both sides of the input
pipeline: the provider's parse look-ahead (``io/provider.py``) and the
staged-item buffer of ``io/staging.prefetch``. This module is its one
source, as in the JAX package's ``io/__init__.py``.
"""

from __future__ import annotations

import os

ENV_PREFETCH_DEPTH = "EEG_TPU_PREFETCH_DEPTH"
_DEFAULT_PREFETCH_DEPTH = 2


def env_int(name: str, default: int) -> int:
    """A positive-integer env knob; unset or garbage gives ``default``."""
    try:
        return max(1, int(os.environ.get(name, "")))
    except ValueError:
        return default


def default_prefetch_depth() -> int:
    """``EEG_TPU_PREFETCH_DEPTH``, else 2 (double buffering)."""
    return env_int(ENV_PREFETCH_DEPTH, _DEFAULT_PREFETCH_DEPTH)
