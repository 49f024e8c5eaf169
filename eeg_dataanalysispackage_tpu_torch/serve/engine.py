"""The resident serving engine: raw epoch windows -> predictions.

Port of the JAX package's ``serve/engine.py``. One
micro-batch of requests — each carrying the raw samples of one
stimulus-locked window: unscaled int16 for INT_16 recordings, float32
with unit resolutions otherwise (the ``stage_raw`` convention) — runs
through one of two rungs, both hand-written CUDA kernels on the card:

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

The served model is one immutable snapshot (:class:`ServedModel`: the
classifier, its weights on the device, intercept and threshold) that
:meth:`ServingEngine.execute` reads once per batch, so
:meth:`ServingEngine.swap_model` (the serving lifecycle's hot swap, one
host-to-device copy of the new weights and one assignment) never pairs
one model's weights with another's intercept: a batch is served wholly
by the old or wholly by the new model. :meth:`ServingEngine.featurize`
gives the lifecycle its feedback rows through the fused rung, the
computation that features served traffic.

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

The multi-tenant engine (``serve/multiplex.py``) is a subclass: it
overrides the rungs' margin hooks (:meth:`ServingEngine._mega_margins`,
:meth:`ServingEngine._fused_margins`), the intercept and threshold step
(:meth:`ServingEngine._postprocess`), the megakernel program
(:meth:`ServingEngine._make_mega_program`) and :meth:`ServingEngine.warmup`
(its weights gate runs before this warmup's gates), and keeps the rest.

Every rung takes any analysis window and coefficient count whose live
window fits the padded stride: the kernels run their ring engine at the
main path's 512 / 16 and their generic engine at every other size. Each
rung stages a batch in its windows' own dtype, so float32 windows run
the kernels' float32-sample instantiations (K1-f32 on the fused rung,
K5-f32s on the mega rung); :meth:`ServingEngine.warmup` runs one batch
of each dtype.

**The host-extractor mode** (``host_extractor=`` a registry feature
extractor, ``features.registry.create``): the engine is pinned to the
``host`` rung (``mode`` ``"host-extractor"``) and builds no kernel of
its own. Each batch is scaled and baseline-corrected on the host in
float64 (with ``pre=0``, not corrected), featurized by the extractor's
``extract_batch`` (a ``-pallas`` extractor on the card launches the
epoch-features kernel, ``csrc/epoch_features.cu``, once a batch) and
classified by the classifier's own ``predict``; no margins are returned.
The warmup runs one window through the extractor, so its kernel builds
before traffic. A non-f32 ``precision`` is recorded as ``used:
"host-f64"``.

**Classifiers without a fused margin** (``mode`` ``"featurize+host"``):
a non-linear classifier (``nn``; the trees ``dt``, ``rf``, ``gbt`` and
their ``-tpu`` names, which have no linear weights), or a linear one not
yet trained, is served as the JAX package serves it. The batch goes
through the fused rung's ingest kernel without a margin and the
classifier's own ``predict`` runs on the rows (the network's products on
the engine's device; a tree bins the rows on the host and walks them
there, or on the rows' device for ``dt-tpu``/``rf-tpu``); no margins are
returned and the mega rung is not a candidate (``mega_record`` None). An untrained classifier's
``predict`` raises at warmup, its own "model not trained or loaded".
A hot swap into such an engine takes any classifier with a ``predict``.
A linear model with float64 weights (an imported MLlib model directory)
is served in this mode too, as in the JAX package: it keeps its
bit-exact host float64 predict, which a fused margin would downcast.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

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

#: lane width of the multi-tenant weight stack (serve/multiplex.py): one
#: tenant per row of a tenant-major (MAX_TENANTS, C*K) matrix, so one
#: program serves any tenant mix and a tenant add or swap rewrites one row
MAX_TENANTS = serve_mega.MAX_TENANTS


def weights_of(classifier) -> Optional[np.ndarray]:
    """A classifier's linear weights as a host array, or None."""
    weight = getattr(getattr(classifier, "model", None), "weight", None)
    return None if weight is None else weight.detach().cpu().numpy()


class ServedModel(NamedTuple):
    """The model a solo engine serves, replaced whole by a swap."""

    classifier: object
    #: (C*K,) float32 weights on the engine's device; None without a
    #: fused margin
    weights: Optional[torch.Tensor]
    intercept: float
    threshold: float


class ServingEngine:
    """Executes micro-batches for one loaded classifier on ``device``
    (``None`` -> ``cuda``; raises without a card)."""

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
        weights = weights_of(classifier) if isinstance(
            classifier, linear._LinearClassifier) else None
        #: the fused-margin path: trained float32 linear weights; every
        #: other classifier, float64 (imported MLlib) weights included, is
        #: featurized by the fused rung and predicts itself (the JAX
        #: package's "featurize+host" mode)
        self._fused_linear = weights is not None and weights.dtype == np.float32
        self.device = resolve_device(device)
        #: the served model; replaced whole by :meth:`swap_model`
        self._model = self._served(classifier)
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
        self._warmed = False
        #: the host-extractor mode's registry extractor; None otherwise
        self._host_fe = host_extractor
        # the host-extractor mode builds no kernel of the engine's own:
        # the host rung is the mode
        self._rung = "fused" if host_extractor is None else "host"
        self._fused = None if host_extractor is not None else self._fused_featurizer(precision)
        # the synthetic stream's static plan: window i lives at
        # [i * window_len, (i + 1) * window_len), its marker at + pre
        self._positions = (
            np.arange(self.capacity, dtype=np.int32) * self.window_len + self.pre
        )
        self._mega_stride = serve_mega.padded_stride(self.pre, self.post)
        # built at warmup, at the precision the precision gate leaves
        self._mega_program = None

    def _served(self, classifier) -> ServedModel:
        """``classifier``'s snapshot, its weights copied to the device
        (no weights, intercept or threshold without a fused margin)."""
        if not self._fused_linear:
            return ServedModel(classifier, None, 0.0, 0.0)
        return ServedModel(
            classifier,
            classifier.model.weight.to(self.device).contiguous(),
            float(classifier.model.intercept),
            float(classifier.margin_threshold),
        )

    @property
    def classifier(self):
        """The classifier being served."""
        return self._model.classifier

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
        ``(n_channels, window_len)`` raw sample arrays (int16 for INT_16
        recordings; float32 with unit resolutions otherwise), all sharing
        ``resolutions``. Returns ``(predictions (B,) float64, margins
        (B,) float32)``; the host-extractor mode returns no margins
        (``None``)."""
        n = len(windows)
        if n == 0:
            return np.zeros((0,), np.float64), None
        if n > self.capacity:
            raise ValueError(
                f"micro-batch of {n} exceeds engine capacity {self.capacity}"
            )
        # the one read of the served model: a swap during this batch
        # serves the next one
        model = self._model
        if self._rung == "host":
            return self._execute_host(windows, resolutions, model)
        res = torch.from_numpy(np.asarray(resolutions, dtype=np.float32)).to(self.device)
        if not self._fused_linear:
            feats = self._fused_features(self._fused, windows, res)[:n]
            predictions = model.classifier.predict(feats)
            return predictions.cpu().numpy().astype(np.float64, copy=False), None
        if self._rung == "mega":
            margins = self._mega_margins(windows, res, model)
        else:
            margins = self._fused_margins(windows, res, model)
        # the batch's one sync: the margins' device-to-host copy
        return self._postprocess(margins[:n].cpu().numpy(), model)

    def _postprocess(self, margins: np.ndarray, model: ServedModel
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(n,) float32 margins before the intercept -> ``(predictions
        (n,) float64, margins (n,) float32)``: ``model``'s intercept
        added and its strict ``margin > threshold``, both in float32."""
        margins = margins + np.float32(model.intercept)
        predictions = (margins > np.float32(model.threshold)).astype(np.float64)
        return predictions, margins

    def _check_windows(self, windows) -> None:
        """Every window ``(n_channels, window_len)``, int16 or float32,
        and of one dtype: a batch is staged in its windows' dtype."""
        dtype = np.asarray(windows[0]).dtype
        for i, w in enumerate(windows):
            w = np.asarray(w)
            if w.shape != (self.n_channels, self.window_len):
                raise ValueError(
                    f"window {i} has shape {w.shape}, expected "
                    f"({self.n_channels}, {self.window_len})"
                )
            if w.dtype not in (np.int16, np.float32) or w.dtype != dtype:
                raise ValueError(
                    f"window {i} is {w.dtype}; a batch holds int16 or float32 "
                    f"windows of one dtype (window 0 is {dtype})"
                )

    def _execute_host(self, windows, resolutions, model: ServedModel):
        """The host-extractor mode: :meth:`_host_features`, then
        ``model``'s classifier's own ``predict``; no margins."""
        feats = self._host_features(windows, resolutions)
        predictions = model.classifier.predict(feats)
        return predictions.cpu().numpy().astype(np.float64, copy=False), None

    def _host_features(self, windows, resolutions) -> torch.Tensor:
        """Each window scaled by ``resolutions`` in float64, its
        pre-stimulus mean subtracted from the samples after it (with
        ``pre=0`` the window as it is), then the host extractor's
        ``extract_batch``: (n, d) rows on the engine's device (a host
        extractor's numpy rows are moved there)."""
        res = np.asarray(resolutions, dtype=np.float64)
        epochs = []
        for i, w in enumerate(windows):
            w = np.asarray(w)
            if w.shape != (self.n_channels, self.window_len):
                raise ValueError(
                    f"window {i} has shape {w.shape}, expected "
                    f"({self.n_channels}, {self.window_len})"
                )
            scaled = w.astype(np.float64) * res[:, None]
            if self.pre:
                base = scaled[:, :self.pre].mean(axis=1)
                epochs.append((scaled - base[:, None])[:, self.pre:])
            else:
                epochs.append(scaled)
        return torch.as_tensor(self._host_fe.extract_batch(np.stack(epochs)), device=self.device)

    def _mega_margins(self, windows, res, model: ServedModel) -> torch.Tensor:
        """The megakernel rung: the batch at the padded stride, one
        host-to-device copy, one launch with ``model``'s weights;
        (capacity,) margins before the intercept, on the device."""
        return self._mega_program(self._stage_mega(windows), res, model.weights)

    def _stage_mega(self, windows) -> torch.Tensor:
        """The batch at the padded stride on the device (one copy)."""
        self._check_windows(windows)
        stream = serve_mega.stage_mega_stream(
            windows, self.n_channels, self.window_len, self._mega_stride,
            self.capacity,
        )
        return torch.from_numpy(stream).to(self.device, non_blocking=False)

    def _fused_margins(self, windows, res, model: ServedModel) -> torch.Tensor:
        """The fused rung: the batch as a synthetic recording through
        the batch path's fused ingest kernel, then ``feats @ weights``
        with ``model``'s weights; (capacity,) margins before the
        intercept, on the device."""
        return self._fused_features(self._fused, windows, res) @ model.weights

    def _fused_features(self, featurize, windows, res) -> torch.Tensor:
        """(capacity, C*K) feature rows of the batch laid out as a
        synthetic recording in the windows' own dtype, through
        ``featurize``; padded rows zero."""
        self._check_windows(windows)
        n = len(windows)
        stream = np.zeros(
            (self.n_channels, self.capacity * self.window_len),
            dtype=np.asarray(windows[0]).dtype,
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
        that gate fails. Then one batch of each request dtype (int16 and
        float32) runs on the rung that serves. The host-extractor mode
        builds no kernel of its own: one window goes through its
        extractor (so a kernel-backed one, ``-pallas``, builds here, not
        in the batcher), and at a non-f32 ``precision`` it records
        ``used: "host-f64"``. Idempotent."""
        if self._warmed:
            return
        if self._host_fe is not None:
            if self._precision != "f32":
                self.precision_record = {
                    "requested": self._precision, "used": "host-f64", "gate": None,
                }
            self._host_features([np.zeros((self.n_channels, self.window_len), np.float32)],
                                np.ones(self.n_channels, np.float32))
            self._warmed = True
            return
        effective = "f32"
        if self._precision != "f32":
            effective = self._precision_warmup_gate()
        if (self._fused_linear and self._engine_rung_requested != "fused"
                and effective != "bf16"):
            self._mega_program = self._make_mega_program(effective)
            self._mega_warmup(effective)
        for dtype in (np.int16, np.float32):
            self.execute(
                [np.zeros((self.n_channels, self.window_len), dtype)],
                np.ones(self.n_channels, np.float32),
            )
        self._warmed = True

    def _make_mega_program(self, precision: str):
        """The megakernel program of this engine's geometry at
        ``precision``."""
        return serve_mega.make_serve_mega_program(
            wavelet_index=self.wavelet_index, epoch_size=self.epoch_size,
            skip_samples=self.skip_samples, feature_size=self.feature_size,
            n_channels=self.n_channels, pre=self.pre, post=self.post,
            capacity=self.capacity, precision=precision,
        )

    def featurize(self, windows: Sequence[np.ndarray], resolutions: np.ndarray) -> np.ndarray:
        """(n, d) float32 feature rows of ``windows`` through the fused
        rung (the ingest kernel at the precision the warmup gate left, on
        the windows' own sample type), or in the host-extractor mode
        through the host extractor: the computation that features served
        traffic, the serving lifecycle's feedback rows. Batches past the
        capacity run in capacity-sized slices; the padded rows are
        dropped."""
        n = len(windows)
        if n == 0:
            return np.zeros((0, self.n_channels * self.feature_size), np.float32)
        if n > self.capacity:
            return np.concatenate([
                self.featurize(windows[i:i + self.capacity], resolutions)
                for i in range(0, n, self.capacity)
            ], axis=0)
        if self._host_fe is not None:
            feats = self._host_features(windows, resolutions)
        else:
            res = torch.from_numpy(np.asarray(resolutions, dtype=np.float32)).to(self.device)
            feats = self._fused_features(self._fused, windows, res)[:n]
        return feats.cpu().numpy().astype(np.float32, copy=False)

    def swap_model(self, classifier, tenant: Optional[str] = None):
        """Hot-swap the served model; returns the displaced classifier.

        The replacement must carry float32 linear weights of the live
        shape: it then runs the kernels already built, with one
        host-to-device copy of its weights and one assignment of the
        snapshot (no library is built, the mega program object stays).
        An in-flight batch read the old snapshot and is served wholly by
        it. ``tenant`` is the multi-tenant engine's keyed swap
        (serve/multiplex.py); this single-model engine refuses it rather
        than swap the wrong tenant's traffic."""
        if tenant is not None:
            raise ValueError(
                f"this engine serves one model; a tenant-keyed swap "
                f"(tenant={tenant!r}) needs the MultiplexedEngine "
                f"(serve/multiplex.py)"
            )
        old = self._model
        if not self._fused_linear:
            if getattr(classifier, "predict", None) is None:
                raise ValueError("hot swap requires a classifier with a predict surface")
            self._model = ServedModel(classifier, None, 0.0, 0.0)
            return old.classifier
        w = weights_of(classifier)
        live_shape = tuple(old.weights.shape)
        if (
            not isinstance(classifier, linear._LinearClassifier)
            or w is None
            or w.dtype != np.float32
            or w.shape != live_shape
        ):
            raise ValueError(
                "hot swap requires float32 linear weights of the live shape "
                f"{live_shape} (the zero-recompile contract); got "
                f"{None if w is None else (w.dtype, w.shape)}"
            )
        self._model = self._served(classifier)
        return old.classifier

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
        model = self._model
        mega = self._mega_margins(windows, res, model)[:n].cpu().numpy()
        fused = self._fused_margins(windows, res, model)[:n].cpu().numpy()
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
        if self._host_fe is not None:
            return "host-extractor"
        return "fused-linear" if self._fused_linear else "featurize+host"

    @property
    def rung(self) -> str:
        """The rung currently serving: ``mega`` (promoted at warmup),
        ``fused``, or ``host`` (the host-extractor mode)."""
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
    ``(n_channels, pre+post)`` windows (the bytes ``stage_raw`` ships to
    the device, sliced per epoch, zero past the end of the recording:
    unscaled int16 for INT_16 recordings, already scaled float32 with
    unit resolutions otherwise), their 0/1 targets under the shared
    cross-file ``balance`` state, and the per-channel resolutions. The
    serve pipeline drives a batch session through the service with it.
    """
    raw, resolutions, n_samples = device_ingest.stage_raw(
        recording, list(channel_indices), torch.device("cpu")
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
