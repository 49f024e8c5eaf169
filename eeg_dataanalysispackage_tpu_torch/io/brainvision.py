"""BrainVision (.vhdr/.vmrk/.eeg) reader.

Parses the Brain Vision Data Exchange format (INI-style header + marker
files, multiplexed int16 binary data) the way the reference's closed
``eegloader-hdfs`` jar does (OffLineDataProvider.java:167-196). Pure
Python parsers and a numpy demux; the fused path ships the unscaled
int16 samples to the card and scales them there.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelInfo:
    """One ``Ch<n>=<Name>,<Ref>,<Resolution>,<Unit>`` entry."""

    number: int  # 1-based channel number, as in the header
    name: str
    reference: str
    resolution: float
    units: str


@dataclasses.dataclass(frozen=True)
class Marker:
    """One ``Mk<n>=<Type>,<Description>,<Position>,...`` entry.

    ``position`` is the raw position-in-data-points field, used directly
    as the sample index (OffLineDataProvider.java:220-225).
    """

    name: str
    kind: str
    stimulus: str
    position: int

    def stimulus_index(self) -> int:
        """Digits of the stimulus text minus one; -1 when no digits
        (OffLineDataProvider.java:207-214)."""
        digits = re.sub(r"\D", "", self.stimulus)
        if digits:
            return int(digits) - 1
        return -1


@dataclasses.dataclass(frozen=True)
class Header:
    data_file: str
    marker_file: str
    data_format: str  # BINARY
    orientation: str  # MULTIPLEXED | VECTORIZED
    num_channels: int
    sampling_interval_us: float
    binary_format: str  # INT_16 | IEEE_FLOAT_32
    channels: List[ChannelInfo]

    def channel_index(self, name: str) -> Optional[int]:
        """0-based index of a channel by case-insensitive name."""
        lname = name.lower()
        for i, ch in enumerate(self.channels):
            if ch.name.lower() == lname:
                return i
        return None


_SECTION_RE = re.compile(r"^\[(?P<name>.+)\]\s*$")
_KV_RE = re.compile(r"^(?P<key>[^=;]+)=(?P<value>.*)$")


def _parse_ini(text: str) -> Dict[str, Dict[str, str]]:
    """Minimal INI parse: sections, key=value, ';' comments skipped.

    The [Comment] section of real vhdr files contains free text with
    '=' signs; values are kept verbatim, later sections win on dup keys.
    """
    sections: Dict[str, Dict[str, str]] = {}
    current: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip("\r\n")
        if not line or line.lstrip().startswith(";"):
            continue
        m = _SECTION_RE.match(line.strip())
        if m:
            current = sections.setdefault(m.group("name"), {})
            continue
        if current is None:
            continue
        kv = _KV_RE.match(line)
        if kv:
            current[kv.group("key").strip()] = kv.group("value")
    return sections


def _unescape_name(name: str) -> str:
    # Commas in channel names are coded as "\1" per the format spec.
    return name.replace("\\1", ",")


def parse_vhdr_py(text: str) -> Header:
    sections = _parse_ini(text)
    common = sections.get("Common Infos", {})
    binary = sections.get("Binary Infos", {})
    chan_section = sections.get("Channel Infos", {})

    channels: List[ChannelInfo] = []
    chan_keys = [k for k in chan_section if re.fullmatch(r"Ch\d+", k)]
    for key in sorted(chan_keys, key=lambda k: int(k[2:])):
        parts = chan_section[key].split(",")
        # <Name>,<Reference>,<Resolution>,<Unit>, future extensions
        name = _unescape_name(parts[0]) if parts else ""
        ref = parts[1] if len(parts) > 1 else ""
        res = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        units = parts[3] if len(parts) > 3 else "uV"
        channels.append(
            ChannelInfo(
                number=int(key[2:]),
                name=name,
                reference=ref,
                resolution=res,
                units=units,
            )
        )

    return Header(
        data_file=common.get("DataFile", ""),
        marker_file=common.get("MarkerFile", ""),
        data_format=common.get("DataFormat", "BINARY"),
        orientation=common.get("DataOrientation", "MULTIPLEXED"),
        num_channels=int(common.get("NumberOfChannels", len(channels) or 1)),
        sampling_interval_us=float(common.get("SamplingInterval", 1000)),
        binary_format=binary.get("BinaryFormat", "INT_16"),
        channels=channels,
    )


_MARKER_KEY_RE = re.compile(r"^Mk\d+$")


def parse_vmrk_py(text: str) -> List[Marker]:
    sections = _parse_ini(text)
    infos = sections.get("Marker Infos", {})
    markers: List[Marker] = []
    # preserve numeric Mk order
    for key in sorted(infos, key=lambda k: int(k[2:]) if k[2:].isdigit() else 0):
        if not _MARKER_KEY_RE.match(key):
            continue
        parts = infos[key].split(",")
        kind = parts[0] if parts else ""
        stimulus = _unescape_name(parts[1]) if len(parts) > 1 else ""
        try:
            position = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            position = 0
        markers.append(Marker(name=key, kind=kind, stimulus=stimulus, position=position))
    return markers


_BINARY_DTYPES = {
    "INT_16": np.dtype("<i2"),
    "INT_32": np.dtype("<i4"),
    "IEEE_FLOAT_32": np.dtype("<f4"),
}


class Recording:
    """A parsed BrainVision triplet with lazy channel access."""

    def __init__(self, header: Header, markers: List[Marker], raw: np.ndarray):
        self.header = header
        self.markers = markers
        # raw: (num_samples, num_channels) unscaled samples
        self._raw = raw

    @property
    def num_samples(self) -> int:
        return self._raw.shape[0]

    def raw_int16(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), num_samples) UNSCALED int16 channel matrix.

        The fused path stages these raw samples to the card and scales
        them there, halving host->device bytes against float32. Raises
        TypeError for non-INT_16 recordings.
        """
        if self._raw.dtype != np.int16:
            raise TypeError(
                f"raw_int16 requires INT_16 data, got {self._raw.dtype}"
            )
        return np.ascontiguousarray(self._raw[:, list(indices)].T)

    def resolutions(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices),) float32 per-channel resolution factors."""
        return np.array(
            [self.header.channels[i].resolution for i in indices],
            dtype=np.float32,
        )


def load_recording_bytes(
    vhdr_bytes: bytes, vmrk_bytes: bytes, eeg_bytes: bytes
) -> Recording:
    """Build a :class:`Recording` from an already-read triplet."""
    header = parse_vhdr_py(vhdr_bytes.decode("utf-8", errors="replace"))
    markers = parse_vmrk_py(vmrk_bytes.decode("utf-8", errors="replace"))
    dtype = _BINARY_DTYPES.get(header.binary_format)
    if dtype is None:
        raise ValueError(f"Unsupported BinaryFormat: {header.binary_format}")
    flat = np.frombuffer(eeg_bytes, dtype=dtype)
    nch = header.num_channels
    nsamp = flat.size // nch
    flat = flat[: nsamp * nch]
    if header.orientation.upper() == "MULTIPLEXED":
        raw = flat.reshape(nsamp, nch)
    else:  # VECTORIZED: ch1 all samples, ch2 all samples, ...
        raw = flat.reshape(nch, nsamp).T
    return Recording(header, markers, raw)
