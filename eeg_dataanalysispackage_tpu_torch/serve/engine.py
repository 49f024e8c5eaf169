"""The resident serving engine: raw epoch windows -> predictions.

Port of the JAX package's ``serve/engine.py`` for linear models. One
micro-batch of requests — each carrying the raw (unscaled int16)
samples of one stimulus-locked window — runs through one of two rungs,
both hand-written CUDA kernels on the card:

- ``mega`` (the default): the batch is laid out at the padded stride
  (``ops/serve_mega.stage_mega_stream``), copied to the device once,
  and one launch of the serve megakernel (``csrc/serve_mega.cu``)
  returns the margins; the features never reach device memory;
- ``fused``: the batch is laid out as a synthetic recording (window
  ``i`` at ``i * window_len``) and the batch path's fused ingest kernel
  (``csrc/ingest_features.cu``) featurizes it; the margin is
  ``feats @ weights``.

The engine adds the intercept on the host and applies the model's
threshold. The margins' device-to-host copy is the batch's one sync.

``engine_rung="auto"`` means ``mega`` (the JAX package's CPU default; no
rung is chosen from TPU evidence). :meth:`ServingEngine.warmup` builds
the kernels and holds the mega rung's margins against the fused rung's
on synthetic DC-heavy windows at ``serve_mega.mega_gate_tolerance()``;
a gate miss raises.

``precision="bf16"|"int8"|"int4"`` first runs the JAX package's warmup
precision gate on the same windows: the fused rung at the requested
precision against f32, at the rung's tolerance; above it the engine
serves f32 (recorded in :attr:`ServingEngine.precision_record`). The
mega rung is then built at the effective precision and held against
the fused rung at ``max(MEGA_GATE_TOL, rung tolerance)``; bf16 has no
megakernel and stays on the fused rung (``mega_record`` None).

There is no degradation ladder: a mega failure
during residency raises to the batcher, which retries and then fails
the requests with their history. Both rungs take a fixed capacity (the
configured micro-batch size rounded up to 64), so every batch size from
1 to capacity runs the same shapes, and a window's margin does not
depend on the batch it rides in.

Not ported: float32 (non-INT_16) windows, the host-extractor mode,
non-linear classifiers and the multi-tenant program.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..epochs.extractor import BalanceState
from ..models import linear
from ..ops import decode_ingest, device_ingest, ingest_cuda, serve_mega
from ..utils import constants
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the rungs an engine can be asked for
ENGINE_RUNGS = ("auto", "mega", "fused")


class ServingEngine:
    """Executes micro-batches for one loaded linear classifier on
    ``device`` (``None`` -> ``cuda``; raises without a card)."""

    def __init__(
        self,
        classifier,
        wavelet_index: int = 8,
        n_channels: int = len(constants.CHANNEL_NAMES),
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        epoch_size: int = 512,
        skip_samples: int = 175,
        feature_size: int = 16,
        capacity: int = 64,
        host_extractor=None,
        precision: str = "f32",
        engine_rung: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if host_extractor is not None:
            raise ValueError(
                "the host-extractor serving mode is not yet ported; see ROADMAP.md"
            )
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if precision not in decode_ingest.PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; use one of "
                f"{decode_ingest.PRECISIONS}"
            )
        if engine_rung not in ENGINE_RUNGS:
            raise ValueError(
                f"unknown engine_rung {engine_rung!r}; use 'auto', "
                f"'mega', or 'fused'"
            )
        if not isinstance(classifier, linear._LinearClassifier) or classifier.model is None:
            raise ValueError(
                "serving a non-linear or untrained classifier is not yet "
                "ported; see ROADMAP.md"
            )
        weights = classifier.model.weight
        if weights.dtype != torch.float32:
            raise ValueError(
                f"serving {weights.dtype} linear weights (an imported MLlib "
                "model) is not yet ported; see ROADMAP.md"
            )
        self.device = resolve_device(device)
        self.classifier = classifier
        self._weights = weights.to(self.device).contiguous()
        self._intercept = float(classifier.model.intercept)
        self._threshold = float(classifier.margin_threshold)
        self.n_channels = int(n_channels)
        self.pre = int(pre)
        self.post = int(post)
        self.window_len = self.pre + self.post
        # the batch planner's capacity multiple: served windows run the
        # shapes the batch path's plans run
        self.capacity = max(64, -(-int(capacity) // 64) * 64)
        self.wavelet_index = int(wavelet_index)
        self.epoch_size = int(epoch_size)
        self.skip_samples = int(skip_samples)
        self.feature_size = int(feature_size)
        self._engine_rung_requested = engine_rung
        self._precision = precision
        #: a non-f32 engine's precision request and its warmup gate
        #: decision, ``{"requested", "used", "gate"}``; None at f32
        self.precision_record: Optional[dict] = None
        #: mega-rung resolution and its warmup parity gate; None when
        #: the engine was pinned to the fused rung or serves bf16
        self.mega_record: Optional[dict] = None
        self._rung = "fused"
        self._warmed = False
        self._fused = self._fused_featurizer(precision)
        # the synthetic stream's static plan: window i lives at
        # [i * window_len, (i + 1) * window_len), its marker at + pre
        self._positions = (
            np.arange(self.capacity, dtype=np.int32) * self.window_len + self.pre
        )
        self._mega_stride = serve_mega.padded_stride(self.pre, self.post)
        # built at warmup, at the precision the precision gate leaves
        self._mega_program = None

    def _fused_featurizer(self, precision: str):
        """The fused rung's featurizer at ``precision``."""
        return ingest_cuda.make_cuda_ingest_featurizer(
            wavelet_index=self.wavelet_index, epoch_size=self.epoch_size,
            skip_samples=self.skip_samples, feature_size=self.feature_size,
            pre=self.pre, precision=precision,
        )

    # -- execution ------------------------------------------------------

    def execute(
        self,
        windows: Sequence[np.ndarray],
        resolutions: np.ndarray,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Run one micro-batch: ``windows`` is a sequence of
        ``(n_channels, window_len)`` int16 raw sample arrays, all sharing
        ``resolutions``. Returns ``(predictions (B,) float64, margins
        (B,) float32)``."""
        n = len(windows)
        if n == 0:
            return np.zeros((0,), np.float64), None
        if n > self.capacity:
            raise ValueError(
                f"micro-batch of {n} exceeds engine capacity {self.capacity}"
            )
        res = torch.from_numpy(np.asarray(resolutions, dtype=np.float32)).to(self.device)
        if self._rung == "mega":
            margins = self._mega_margins(windows, res)
        else:
            margins = self._fused_margins(windows, res)
        # the batch's one sync: the margins' device-to-host copy
        margins = margins[:n].cpu().numpy() + np.float32(self._intercept)
        predictions = (margins > np.float32(self._threshold)).astype(np.float64)
        return predictions, margins

    def _check_windows(self, windows) -> None:
        for i, w in enumerate(windows):
            w = np.asarray(w)
            if w.shape != (self.n_channels, self.window_len):
                raise ValueError(
                    f"window {i} has shape {w.shape}, expected "
                    f"({self.n_channels}, {self.window_len})"
                )
            if w.dtype != np.int16:
                raise ValueError(
                    f"serving {w.dtype} windows (non-INT_16 recordings) is "
                    "not yet ported; see ROADMAP.md"
                )

    def _mega_margins(self, windows, res) -> torch.Tensor:
        """The megakernel rung: the batch at the padded stride, one
        host-to-device copy, one launch; (capacity,) margins before the
        intercept, on the device."""
        self._check_windows(windows)
        stream = serve_mega.stage_mega_stream(
            windows, self.n_channels, self.window_len, self._mega_stride,
            self.capacity,
        )
        staged = torch.from_numpy(stream).to(self.device, non_blocking=False)
        return self._mega_program(staged, res, self._weights)

    def _fused_margins(self, windows, res) -> torch.Tensor:
        """The fused rung: the batch as a synthetic recording through
        the batch path's fused ingest kernel, then ``feats @ weights``;
        (capacity,) margins before the intercept, on the device."""
        return self._fused_features(self._fused, windows, res) @ self._weights

    def _fused_features(self, featurize, windows, res) -> torch.Tensor:
        """(capacity, C*K) feature rows of the batch laid out as a
        synthetic recording, through ``featurize``; padded rows zero."""
        self._check_windows(windows)
        n = len(windows)
        stream = np.zeros(
            (self.n_channels, self.capacity * self.window_len), dtype=np.int16
        )
        for i, w in enumerate(windows):
            stream[:, i * self.window_len:(i + 1) * self.window_len] = w
        mask = np.zeros(self.capacity, dtype=bool)
        mask[:n] = True
        staged = torch.from_numpy(stream).to(self.device, non_blocking=False)
        return featurize(staged, res, self._positions, mask)

    # -- warmup ---------------------------------------------------------

    def warmup(self) -> None:
        """Build the kernels and run them before traffic arrives, so a
        cold ``nvcc`` build never happens inside the batcher, where the
        watchdog would read it as a wedge. A non-f32 engine runs its
        precision gate first (:meth:`_precision_warmup_gate`); an engine
        not pinned to ``fused`` and not serving bf16 then holds the mega
        rung against the fused rung (:meth:`_mega_warmup`) and raises if
        that gate fails. Idempotent."""
        if self._warmed:
            return
        effective = "f32"
        if self._precision != "f32":
            effective = self._precision_warmup_gate()
        if self._engine_rung_requested != "fused" and effective != "bf16":
            self._mega_program = serve_mega.make_serve_mega_program(
                wavelet_index=self.wavelet_index, epoch_size=self.epoch_size,
                skip_samples=self.skip_samples, feature_size=self.feature_size,
                n_channels=self.n_channels, pre=self.pre, post=self.post,
                capacity=self.capacity, precision=effective,
            )
            self._mega_warmup(effective)
        self.execute(
            [np.zeros((self.n_channels, self.window_len), np.int16)],
            np.ones(self.n_channels, np.float32),
        )
        self._warmed = True

    def _gate_windows(self):
        """Deterministic synthetic int16 gate windows — full-amplitude
        signal over a large DC offset, the cancellation-stressing shape —
        the JAX package's gate bytes. Returns ``(windows,
        resolutions)``."""
        rng = np.random.RandomState(0)
        n = min(16, self.capacity)
        body = (
            rng.randint(-3000, 3000, size=(self.n_channels, n * self.window_len))
            + np.asarray([15000, -12000, 9000] * 40)[: self.n_channels, None]
        ).astype(np.int16)
        windows = [
            body[:, i * self.window_len:(i + 1) * self.window_len]
            for i in range(n)
        ]
        return windows, np.full(self.n_channels, 0.1, np.float32)

    def _precision_warmup_gate(self) -> str:
        """The serving arm of the precision accuracy gate: the gate
        windows through the fused rung at the requested precision and at
        f32, judged at the rung's tolerance
        (``decode_ingest.feature_precision_gate``). Above it the engine
        serves f32. Returns the effective precision."""
        windows, res_np = self._gate_windows()
        res = torch.from_numpy(res_np).to(self.device)
        f32 = self._fused_featurizer("f32")
        n = len(windows)
        rung_feats = self._fused_features(self._fused, windows, res)[:n]
        f32_feats = self._fused_features(f32, windows, res)[:n]
        gate = decode_ingest.feature_precision_gate(
            rung_feats, f32_feats, precision=self._precision
        )
        used = self._precision if gate["ok"] else "f32"
        self.precision_record = {"requested": self._precision, "used": used, "gate": gate}
        if not gate["ok"]:
            self._fused = f32
            logger.warning(
                "serve.%s_gate auto-disable: max abs dev %.3e > gate %.3e; serving f32",
                self._precision, gate["max_abs_dev"], gate["tolerance"],
            )
        return used

    def _mega_warmup(self, precision: str) -> None:
        """Promote the mega rung after its margins pass the parity gate
        against the fused rung on the gate windows; raise otherwise.
        At int8 or int4 the gate is the rung's tolerance where that is
        looser than ``MEGA_GATE_TOL``: one quantization-boundary flip
        between the two rungs moves a margin by a quantization step."""
        record = {
            "requested": self._engine_rung_requested,
            "resolved": "mega",
            "used": "fused",
            "lowering": "cuda" if self.device.type == "cuda" else "plain",
            "gate": None,
            "precision": precision,
        }
        self.mega_record = record
        windows, res_np = self._gate_windows()
        res = torch.from_numpy(res_np).to(self.device)
        n = len(windows)
        mega = self._mega_margins(windows, res)[:n].cpu().numpy()
        fused = self._fused_margins(windows, res)[:n].cpu().numpy()
        tol = serve_mega.mega_gate_tolerance()
        if precision != "f32":
            tol = max(tol, decode_ingest.precision_gate_tolerance(precision))
        dev = float(np.max(np.abs(mega - fused)))
        gate = {
            "max_abs_dev": dev,
            "tolerance": tol,
            "ok": bool(dev <= tol),
            "rows_checked": n,
        }
        record["gate"] = gate
        if not gate["ok"]:
            raise RuntimeError(
                f"serve mega warmup gate failed: max abs margin deviation "
                f"{dev:.3e} against the fused rung > {tol:.3e}"
            )
        self._rung = "mega"
        record["used"] = "mega"
        logger.info("serve.mega promoted (%s, gate dev %.3e)", record["lowering"], dev)

    @property
    def mode(self) -> str:
        return "fused-linear"

    @property
    def rung(self) -> str:
        """The rung currently serving: ``mega`` (promoted at warmup) or
        ``fused``."""
        return self._rung


def windows_from_recording(
    recording,
    channel_indices: Sequence[int],
    guessed: int,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    post: int = constants.POSTSTIMULUS_SAMPLES,
    balance: Optional[BalanceState] = None,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """One recording -> per-epoch serving requests.

    Returns ``(windows, targets, resolutions)``: the kept markers' raw
    ``(n_channels, pre+post)`` unscaled int16 windows (the bytes
    ``stage_raw`` ships to the device, sliced per epoch, zero past the
    end of the recording), their 0/1 targets under the shared
    cross-file ``balance`` state, and the per-channel resolutions. The
    serve pipeline drives a batch session through the service with it.
    """
    raw, resolutions, n_samples = device_ingest.stage_raw(
        recording, list(channel_indices), torch.device("cpu")
    )
    if raw.dtype != torch.int16:
        raise ValueError(
            f"serving non-INT_16 recordings ({recording.header.binary_format}) "
            "is not yet ported; see ROADMAP.md"
        )
    plan = device_ingest.plan_ingest(
        recording.markers, guessed, n_samples,
        pre=pre, post=post, balance=balance,
    )
    win = pre + post
    padded = np.pad(raw.numpy(), ((0, 0), (0, win)))
    windows = [
        padded[:, p - pre:p - pre + win]
        for p in plan.positions[: plan.n_kept]
    ]
    return windows, plan.targets, resolutions.numpy()
