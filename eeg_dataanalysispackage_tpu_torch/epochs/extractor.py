"""Stimulus-locked epochs with the reference's semantics.

The fused path cuts windows on the card, so it takes only the metadata
half of ``OffLineDataProvider.processEEGFiles``
(OffLineDataProvider.java:200-265): which windows exist
(:func:`valid_window_starts`), and the order-dependent target/non-target
balance scan that decides which of them are kept (:class:`BalanceState`).

The host ``fe=`` path takes the whole engine (:func:`extract_epochs`),
bit for bit:

1. window gather: samples ``[pos-100, pos+750)`` around each marker
   position (out-of-range windows skipped, matching the
   ArrayIndexOutOfBoundsException catch at :262-264);
2. float32 round-trip: the reference narrows double->float
   (``DataProviderUtils.toFloatArray``) before baseline correction;
3. baseline correction in float32 with *sequential* accumulation of the
   first 100 samples (``Baseline.correct(float[],int)`` accumulates a
   float — Baseline.java:29-42). np.cumsum is a sequential left fold,
   so the vectorized form is bit-identical to the Java loop;
4. the trailing 750 samples are widened back to float64
   (``EpochHolder.setFZ/CZ/PZ`` — EpochHolder.java:75-91);
5. the balance scan.

Steps 1-5 run in the native epoch stage (``io/native.py``) when
``EEG_TPU_NATIVE`` is not ``0``; the numpy lines here are its bit-equal
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..io.brainvision import Marker
from ..utils import constants


@dataclasses.dataclass
class EpochBatch:
    """Extracted epochs + labels for one or more recordings."""

    epochs: np.ndarray  # (n, channels, POSTSTIMULUS) float64
    targets: np.ndarray  # (n,) float64 of {0.0, 1.0}
    stimulus_indices: np.ndarray  # (n,) int

    def __len__(self) -> int:
        return self.epochs.shape[0]

    @staticmethod
    def empty(n_channels: int = len(constants.CHANNEL_NAMES),
              post: int = constants.POSTSTIMULUS_SAMPLES) -> "EpochBatch":
        return EpochBatch(
            epochs=np.zeros((0, n_channels, post), dtype=np.float64),
            targets=np.zeros((0,), dtype=np.float64),
            stimulus_indices=np.zeros((0,), dtype=int),
        )

    @staticmethod
    def concatenate(batches: Sequence["EpochBatch"]) -> "EpochBatch":
        if not batches:
            return EpochBatch.empty()
        return EpochBatch(
            epochs=np.concatenate([b.epochs for b in batches], axis=0),
            targets=np.concatenate([b.targets for b in batches], axis=0),
            stimulus_indices=np.concatenate(
                [b.stimulus_indices for b in batches], axis=0
            ),
        )


def valid_window_starts(
    positions: np.ndarray, pre: int, n_samples: int
) -> np.ndarray:
    """Boolean validity of ``[pos-pre, pos+post)`` windows.

    Java's Arrays.copyOfRange(arr, from, to) throws only when
    from < 0 or from > arr.length; a ``to`` beyond the end ZERO-PADS.
    So windows starting in-range but running past the end are kept,
    zero-padded — only windows starting before 0 or after the end are
    dropped (the reference's swallowed AIOOBE,
    OffLineDataProvider.java:262-264). Shared by the host gather and the
    device-ingest planner so retention can never desynchronize.
    """
    positions = np.asarray(positions, dtype=np.int64)
    return (positions - pre >= 0) & (positions - pre <= n_samples)


def gather_windows(
    channels: np.ndarray,
    positions: np.ndarray,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    post: int = constants.POSTSTIMULUS_SAMPLES,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather ``[pos-pre, pos+post)`` windows from full channels.

    channels: (n_channels, n_samples) float64. Returns (windows, valid):
    windows is (n_valid, n_channels, pre+post) float64, zero past the
    end of the recording; ``valid`` is a boolean mask over the input
    positions (False = skipped out-of-range, the reference's swallowed
    ArrayIndexOutOfBoundsException).
    """
    n_samples = channels.shape[1]
    positions = np.asarray(positions, dtype=np.int64)
    valid = valid_window_starts(positions, pre, n_samples)
    starts = positions[valid] - pre
    padded = np.pad(channels, ((0, 0), (0, pre + post)))
    idx = starts[:, None] + np.arange(pre + post)[None, :]
    windows = padded[:, idx]  # (n_channels, n_valid, pre+post)
    return np.ascontiguousarray(windows.transpose(1, 0, 2)), valid


def baseline_correct_f32(windows: np.ndarray, pre: int) -> np.ndarray:
    """float32 baseline correction, bit-identical to Baseline.java.

    windows: (..., pre+post) float64. The double values are narrowed to
    float32, the first ``pre`` samples are summed *sequentially* in
    float32 (np.cumsum is the Java left-to-right fold), divided by
    ``pre`` in float32, and subtracted elementwise in float32. Returns a
    float32 array of the same shape.
    """
    w32 = windows.astype(np.float32)
    seq_sum = np.cumsum(w32[..., :pre], axis=-1, dtype=np.float32)[..., -1]
    baseline = (seq_sum / np.float32(pre)).astype(np.float32)
    return w32 - baseline[..., None]


class BalanceState:
    """The reference's sequential class-balance filter.

    A target epoch is kept only while ``n_targets <= n_nontargets``; a
    non-target only while ``n_targets >= n_nontargets``
    (OffLineDataProvider.java:248-260). Order-dependent by design. The
    counters span all files of an info.txt run
    (OffLineDataProvider.java:58-59), so balancing is global over the
    whole run and the provider must keep the info.txt order.
    """

    def __init__(self) -> None:
        self.n_targets = 0
        self.n_nontargets = 0

    def scan(self, is_target: np.ndarray) -> np.ndarray:
        """The keep mask of ``is_target``, the counters moved past it:
        the native scan (``io/native.py``), or the loop below under
        ``EEG_TPU_NATIVE=0``; the two are bit-equal."""
        from ..io import native

        counters = np.array([self.n_targets, self.n_nontargets], dtype=np.int64)
        keep_native = native.balance_scan(np.asarray(is_target, bool), counters)
        if keep_native is not None:
            self.n_targets, self.n_nontargets = int(counters[0]), int(counters[1])
            return keep_native
        keep = np.zeros(len(is_target), dtype=bool)
        for i, t in enumerate(is_target):
            if t and self.n_targets <= self.n_nontargets:
                keep[i] = True
                self.n_targets += 1
            elif not t and self.n_targets >= self.n_nontargets:
                keep[i] = True
                self.n_nontargets += 1
        return keep


def extract_epochs(
    channels: np.ndarray,
    markers: Sequence[Marker],
    guessed_number: int,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    post: int = constants.POSTSTIMULUS_SAMPLES,
    balance: Optional[BalanceState] = None,
) -> EpochBatch:
    """channels (n_channels, n_samples) float64 + markers -> balanced
    epochs.

    Follows the reference per-marker loop (OffLineDataProvider.java:200-265):
    every marker is considered (including non-Stimulus ones, whose
    empty digit-string yields stimulus index -1 and whose position is
    usually out of range), the window is float32 baseline-corrected,
    the label is 1.0 iff stimulus_index + 1 == guessed_number, and the
    global balance scan decides retention. The gather and baseline run in
    the native epoch stage (``io/native.gather_baseline``), or in numpy
    under ``EEG_TPU_NATIVE=0`` and for windows past its ``MAX_WINDOW``;
    the two are bit-equal.
    """
    from ..io import native

    positions = np.array([m.position for m in markers], dtype=np.int64)
    stim_idx = np.array([m.stimulus_index() for m in markers], dtype=int)

    native_out = native.gather_baseline(np.asarray(channels, dtype=np.float64), positions,
                                        pre, post)
    if native_out is not None:
        epochs, valid = native_out
    else:
        windows, valid = gather_windows(channels, positions, pre, post)
        corrected = baseline_correct_f32(windows, pre)
        # widen to float64 and drop the pre-stimulus prefix (EpochHolder)
        epochs = corrected[..., pre:].astype(np.float64)
    stim_idx = stim_idx[valid]

    is_target = (stim_idx + 1) == guessed_number
    balance = balance or BalanceState()
    keep = balance.scan(is_target)

    return EpochBatch(
        epochs=np.ascontiguousarray(epochs[keep]),
        targets=is_target[keep].astype(np.float64),
        stimulus_indices=stim_idx[keep],
    )
