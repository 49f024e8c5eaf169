"""``fe=`` plugin registry.

Parity with the reference's hard-coded switch
(PipelineBuilder.java:128-139): ``dwt-8`` builds
``WaveletTransform(8, 512, 175, 16)``. The JAX package's spellings parse
the same way: ``dwt-<i>`` (host), ``-tpu``, ``-tpu-compact``,
``-pallas``, and the bf16 spellings, whose backends raise "not yet
ported". Unknown names raise the reference's error message. The
``:``-option subband grammar (``dwt-<i>:level=<L>[:stats=…]``, the
seizure workload) is not ported yet.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Union

import torch

from . import base, wavelet

Device = Optional[Union[str, torch.device]]

_REGISTRY: Dict[str, Callable[[Device], base.FeatureExtraction]] = {}

_BACKENDS = {
    None: "host",
    "-tpu": "xla",
    "-tpu-bf16": "xla-bf16",
    "-tpu-compact": "xla-compact",
    "-tpu-compact-bf16": "xla-compact-bf16",
    "-pallas": "pallas",
}


def register(name: str, factory: Callable[[Device], base.FeatureExtraction]) -> None:
    """``factory(device)`` builds the extractor named ``name``."""
    _REGISTRY[name] = factory


def create(name: str, device: Device = None) -> base.FeatureExtraction:
    """The extractor an ``fe=`` value names, on ``device`` (``None`` ->
    ``cuda``)."""
    if ":" in name:
        raise ValueError(
            f"fe={name}: the subband option grammar is not yet ported; see ROADMAP.md"
        )
    if name in _REGISTRY:
        return _REGISTRY[name](device)
    m = re.fullmatch(
        r"dwt-(\d+)(-tpu-bf16|-tpu-compact-bf16|-tpu-compact|-tpu|-pallas)?",
        name,
    )
    if m:
        return wavelet.WaveletTransform(
            name=int(m.group(1)), backend=_BACKENDS[m.group(2)], device=device
        )
    raise ValueError("Unsupported feature extraction argument")
