"""``fe=`` plugin registry.

Parity with the reference's hard-coded switch
(PipelineBuilder.java:128-139): ``dwt-8`` builds
``WaveletTransform(8, 512, 175, 16)``. The JAX package's spellings parse
the same way: ``dwt-<i>`` (host), ``-tpu``, ``-tpu-compact``,
``-pallas``, and the bf16 spellings ``-tpu-bf16`` and
``-tpu-compact-bf16``. Unknown names raise the reference's error
message.

Extended grammar (the seizure workload): a plain name may carry
``:``-separated options,

    dwt-<family>:level=<L>[:stats=<s1>,<s2>,...]

which selects :class:`features.subband.SubbandWaveletFeatures` (wavelet
family, decomposition level, per-subband statistic set) instead of the
raw-coefficient extractor, with the JAX package's grammar and messages.
Plain names (no ``:``) resolve as before.
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


def _create_subband(base_name: str, opts: list, device: Device) -> base.FeatureExtraction:
    """``dwt-<family>:level=<L>[:stats=...]`` -> SubbandWaveletFeatures.
    The options arrive verbatim: the query parser splits at the first
    ``=`` only."""
    from . import subband

    m = re.fullmatch(r"dwt-(\d+)", base_name)
    if m is None:
        raise ValueError(
            "subband options (level=/stats=) apply to the plain "
            f"dwt-<family> form, got {base_name!r}"
        )
    kwargs: Dict = {"name": int(m.group(1))}
    for opt in opts:
        key, sep, value = opt.partition("=")
        if not sep or not value:
            raise ValueError(
                f"malformed fe= option {opt!r}; expected level=<n> or stats=<s1>,<s2>"
            )
        if key == "level":
            try:
                kwargs["level"] = int(value)
            except ValueError:
                raise ValueError(f"fe= level must be an integer, got {value!r}")
        elif key == "stats":
            kwargs["stats"] = tuple(s for s in value.split(",") if s)
        else:
            raise ValueError(f"unknown fe= option {key!r}; supported: level, stats")
    return subband.SubbandWaveletFeatures(**kwargs, device=device)


def create(name: str, device: Device = None) -> base.FeatureExtraction:
    """The extractor an ``fe=`` value names, on ``device`` (``None`` ->
    ``cuda``)."""
    base_name, sep, rest = name.partition(":")
    if sep:
        return _create_subband(base_name, rest.split(":"), device)
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
