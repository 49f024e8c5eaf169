"""Multi-tenant serving: many tenants' linear models, one resident engine.

Port of the JAX package's ``serve/multiplex.py``. A single-model service
gives every tenant its own engine,
batcher and queue; here N tenants' weight vectors are the rows of one
tenant-major ``(MAX_TENANTS, C*K)`` float32 stack on the device (the
transpose of the JAX package's ``(C*K, 128)`` matrix, whose layout the
host mirror keeps), and one engine serves every tenant mix:

- each request carries a tenant; the batcher coalesces mixed-tenant
  requests into one batch (the tenant is not in the batch key);
- the ``mega`` rung runs the tenant-stacked megakernel (K6,
  ``csrc/serve_mega.cu``), which picks each row's tenant weights inside
  the kernel; the ``fused`` rung runs the fused ingest kernel and, for
  every lane present, the solo rung's own ``feats @ weights``
  (``ops/serve_mega.lane_margins``). Either way a tenant's margins and
  predictions are bit-identical to a solo engine serving that tenant on
  the same rung;
- adding, swapping or removing a tenant rewrites one column of the host
  mirror and publishes a new immutable :class:`TenantStack` with one
  host-to-device copy of the 24 KB stack: no kernel is built and no
  program is made.

**The quantized stack** (``weights_precision="int8"|"int4"``). The f32
host mirror stays master; once the warmup's weights gate has promoted
the requested precision, each publish quantizes it
(``ops/quant.quantize_weight_stack``, per-lane scales, so an admin call
on one tenant leaves every other lane's bytes and scale unchanged) and
copies the packed stack and its scales to the device in one copy (6,656
bytes at int8, 3,584 at int4, against 24,576 at f32). The ``mega`` rung
runs K6-w8 or K6-w4 (the tenant-stacked megakernel reading the packed
rows); the ``fused`` rung dequantizes the payload on the device
(``quant.dequantize_weight_stack``) and takes the same per-lane
matvecs. The warmup order is the JAX package's: the weights gate first
(the quantized fused rung's margins against the f32 stack's on the gate
windows, lanes cycling over the tenants, at
``quant.weights_gate_tolerance``; a miss leaves the f32 stack standing,
recorded in :attr:`MultiplexedEngine.weights_record`), then the mega
gate at the residency that was published. An exception while building
or launching the quantized path raises. Nothing steps down at run time:
a failed quantized batch goes to the batcher's retries and then fails
its requests, as any failed batch does, and the stack stays quantized.

**Isolation.** :meth:`MultiplexedEngine.execute` reads the published
stack once per batch, so an admin call on tenant A never tears tenant
B's in-flight batch. A per-tenant admission quota
(``ServeConfig.tenant_quota``) sheds one noisy tenant's burst against its
own budget, with that tenant's depth and oldest age as evidence.

As in the solo engine, the warmup gate holds the mega rung against the
fused rung at ``serve_mega.mega_gate_tolerance()``, with the gate
windows' lanes cycling over the registered tenants; a miss raises, and
nothing steps down.

Not ported: the JAX package's runtime step-down of the quantized stack
to the f32 mirror (``_disable_weights_quant``) and its
``serve.weights_quant_unavailable`` fallback, its ``accelerator_decision``
(it reads TPU sweep artifacts), the host rung, event records and
tenant-scoped chaos.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import batcher as batcher_mod
from . import engine as engine_mod
from . import service as service_mod
from ..models import linear
from ..models import registry as clf_registry
from ..obs import metrics_export
from ..ops import quant, serve_mega
from ..utils import constants

logger = logging.getLogger(__name__)

#: lane width of the tenant stack: one row per tenant
MAX_TENANTS = engine_mod.MAX_TENANTS

#: the weight-stack precisions (``ops/quant.py``)
WEIGHTS_PRECISIONS = quant.WEIGHTS_PRECISIONS


class TenantStack(NamedTuple):
    """One immutable snapshot of the tenant state, read once per batch.

    ``weights`` is the device-resident tenant-major ``(MAX_TENANTS,
    C*K)`` float32 stack (tenant t's weights in row ``lane[t]``, free
    lanes zero); ``intercepts`` and ``thresholds`` are the per-lane
    values as ``(MAX_TENANTS,)`` float32 host arrays, each the float32
    the solo engine adds and compares with; ``classifiers`` holds each
    lane's classifier (or None); ``generations`` counts each lane's
    swaps and removals. A quantized stack (``weights_precision`` int8 or
    int4) has ``weights`` None and keeps instead its resident payload:
    ``packed``, tenant-major ``(MAX_TENANTS, C*K)`` int8 levels or
    ``(MAX_TENANTS, C*K/2)`` uint8 nibble pairs, and ``scales``
    ``(MAX_TENANTS,)`` float32, views of one device buffer."""

    weights: Optional[torch.Tensor]
    intercepts: np.ndarray
    thresholds: np.ndarray
    classifiers: tuple
    generations: tuple
    packed: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    weights_precision: str = "f32"


class MultiplexedEngine(engine_mod.ServingEngine):
    """One resident engine serving N tenants' models on ``device``
    (``None`` -> ``cuda``; raises without a card).

    ``tenants`` maps tenant name -> trained or loaded classifier; every
    tenant must be a linear classifier with float32 weights of one
    shape. The solo engine's rungs, warmup gate and geometry stand; each
    batch carries one lane per row and the rungs pick that row's tenant
    weights. ``weights_precision`` int8 or int4 asks for the quantized
    stack, promoted at warmup behind the weights gate."""

    def __init__(
        self,
        tenants,
        wavelet_index: int = 8,
        n_channels: int = len(constants.CHANNEL_NAMES),
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        epoch_size: int = 512,
        skip_samples: int = 175,
        feature_size: int = 16,
        capacity: int = 64,
        engine_rung: str = "auto",
        weights_precision: str = "f32",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if weights_precision not in WEIGHTS_PRECISIONS:
            raise ValueError(
                f"weights_precision= must be one of {WEIGHTS_PRECISIONS}, "
                f"got {weights_precision!r}"
            )
        items = list(tenants.items() if isinstance(tenants, dict) else tenants)
        if not items:
            raise ValueError("a multiplexed engine needs at least one tenant")
        if len(items) > MAX_TENANTS:
            raise ValueError(
                f"{len(items)} tenants exceed the {MAX_TENANTS}-lane stack"
            )
        first_name, first_clf = items[0]
        self._require_fused_linear(first_name, first_clf)
        super().__init__(
            first_clf,
            wavelet_index=wavelet_index,
            n_channels=n_channels,
            pre=pre,
            post=post,
            epoch_size=epoch_size,
            skip_samples=skip_samples,
            feature_size=feature_size,
            capacity=capacity,
            precision="f32",
            engine_rung=engine_rung,
            device=device,
        )
        self._weight_shape = engine_mod.weights_of(first_clf).shape
        # the registry: name -> lane. Every mutation holds the lock and
        # ends in _publish(); execute reads the published snapshot once
        self._tenant_lock = threading.RLock()
        self._lanes: Dict[str, int] = {}
        #: the host mirror, in the JAX package's (C*K, MAX_TENANTS) layout
        self._w_host = np.zeros(
            (int(np.prod(self._weight_shape)), MAX_TENANTS), np.float32
        )
        self._intercepts = [0.0] * MAX_TENANTS
        self._thresholds = [0.0] * MAX_TENANTS
        self._classifiers: List[object] = [None] * MAX_TENANTS
        self._generations = [0] * MAX_TENANTS
        self._stack: Optional[TenantStack] = None
        #: the requested stack precision; the active one starts at f32 and
        #: becomes the requested one only when the warmup's weights gate
        #: passes (_weights_quant_warmup)
        self._weights_precision_requested = weights_precision
        self._weights_precision = "f32"
        #: the weights gate's decision, ``{"requested", "used", "gate"}``;
        #: None at f32
        self.weights_record: Optional[dict] = None
        self._resident_bytes = 0
        # the batch in hand, (stack, lanes), set by execute (and by the
        # warmup gate) for the rung hooks; one batcher thread drives the
        # engine, as it drives the solo engine
        self._batch: Optional[Tuple[TenantStack, np.ndarray]] = None
        for name, clf in items:
            self._admit(name, clf)
        self._publish()

    # -- tenant registry ------------------------------------------------

    @staticmethod
    def _require_fused_linear(name: str, classifier) -> None:
        w = engine_mod.weights_of(classifier)
        if (
            not isinstance(classifier, linear._LinearClassifier)
            or w is None
            or w.dtype != np.float32
        ):
            raise ValueError(
                f"tenant {name!r} is not multiplexable: the stacked "
                f"engine needs the fused-linear family (trained "
                f"float32 linear weights); got "
                f"{type(classifier).__name__} with weights="
                f"{None if w is None else (w.dtype, w.shape)}"
            )

    def _write_lane(self, lane: int, classifier) -> None:
        self._w_host[:, lane] = engine_mod.weights_of(classifier).reshape(-1)
        self._intercepts[lane] = float(classifier.model.intercept)
        self._thresholds[lane] = float(classifier.margin_threshold)
        self._classifiers[lane] = classifier

    def _admit(self, name: str, classifier) -> int:
        """Register one tenant in the first free lane (the caller
        publishes)."""
        self._require_fused_linear(name, classifier)
        shape = engine_mod.weights_of(classifier).shape
        if shape != self._weight_shape:
            raise ValueError(
                f"tenant {name!r} has weights of shape {shape}; the stack "
                f"serves {self._weight_shape} (one geometry)"
            )
        if name in self._lanes:
            raise ValueError(f"tenant {name!r} is already registered")
        lane = next(
            (i for i in range(MAX_TENANTS) if self._classifiers[i] is None), None
        )
        if lane is None:
            raise ValueError(f"tenant stack is full ({MAX_TENANTS} lanes)")
        self._lanes[name] = lane
        self._write_lane(lane, classifier)
        return lane

    def _publish(self) -> None:
        """Copy the host mirror's tenant-major transpose to the device
        and publish a new immutable stack; with a promoted quantized
        stack, the mirror quantized (:func:`quant.quantize_weight_stack`)
        and its packed rows and scales, in one copy. No kernel is built
        and no program made; an in-flight batch holds the previous
        snapshot and is served wholly by it."""
        common = dict(
            intercepts=np.asarray(self._intercepts, np.float32),
            thresholds=np.asarray(self._thresholds, np.float32),
            classifiers=tuple(self._classifiers),
            generations=tuple(self._generations),
        )
        wp = self._weights_precision
        if wp == "f32":
            self._resident_bytes = int(self._w_host.nbytes)
            weights = torch.from_numpy(self._w_host.T.copy()).to(self.device)
            self._stack = TenantStack(weights=weights, **common)
            return
        packed_np, scales_np = quant.quantize_weight_stack(self._w_host, wp)
        packed, scales = self._to_device(packed_np, scales_np)
        self._resident_bytes = quant.resident_weight_bytes(packed_np, scales_np)
        self._stack = TenantStack(weights=None, packed=packed, scales=scales,
                                  weights_precision=wp, **common)

    def _to_device(self, packed_np: np.ndarray, scales_np: np.ndarray):
        """The quantized payload on the device in one host-to-device
        copy: the packed stack tenant-major (the transpose of the host
        (d, 128) layout), then the scales; returns views of that buffer,
        ``(packed (MAX_TENANTS, cols), scales (MAX_TENANTS,))``."""
        rows = np.ascontiguousarray(packed_np.T)
        buf = np.concatenate([rows.reshape(-1).view(np.uint8),
                              np.ascontiguousarray(scales_np, np.float32).view(np.uint8)])
        dev = torch.from_numpy(buf).to(self.device)
        dtype = torch.int8 if rows.dtype == np.int8 else torch.uint8
        packed = dev[:rows.size].view(dtype).view(rows.shape)
        return packed, dev[rows.size:].view(torch.float32)

    @property
    def tenants(self) -> Tuple[str, ...]:
        """Registered tenant names, in lane order."""
        with self._tenant_lock:
            return tuple(sorted(self._lanes, key=self._lanes.__getitem__))

    def has_tenant(self, name: str) -> bool:
        with self._tenant_lock:
            return name in self._lanes

    def tenant_info(self, name: str) -> dict:
        """One tenant's registry record: its lane and swap generation."""
        with self._tenant_lock:
            if name not in self._lanes:
                raise ValueError(f"unknown tenant {name!r}")
            lane = self._lanes[name]
            return {"lane": lane, "generation": self._generations[lane]}

    @property
    def resident_weight_bytes(self) -> int:
        """Bytes of the device-resident weight stack: every tenant's
        model (one matrix serves all 128 lanes); with a promoted
        quantized stack, its packed rows and per-lane scales."""
        return int(self._resident_bytes)

    @property
    def weights_precision(self) -> str:
        """The active stack's precision: f32 until the warmup's weights
        gate promotes the requested one."""
        return self._weights_precision

    def add_tenant(self, name: str, classifier) -> int:
        """Register a tenant at runtime; returns its lane. One column
        write and one copy: nothing is built, and the other tenants'
        in-flight traffic is untouched."""
        with self._tenant_lock:
            lane = self._admit(name, classifier)
            self._publish()
        logger.info("serve.tenant_added %s lane %d", name, lane)
        return lane

    def remove_tenant(self, name: str):
        """Unregister a tenant; returns its classifier. Its lane is
        zeroed and freed for reuse. A batch already executing rides the
        snapshot it started with; the tenant's requests still queued fail
        alone when their batch runs (``batcher.UnknownTenantError``), and
        new submissions are refused by the service's registry check."""
        with self._tenant_lock:
            if name not in self._lanes:
                raise ValueError(f"unknown tenant {name!r}")
            if len(self._lanes) == 1:
                raise ValueError(
                    f"cannot remove {name!r}: a multiplexed engine serves at "
                    "least one tenant"
                )
            lane = self._lanes.pop(name)
            displaced = self._classifiers[lane]
            self._classifiers[lane] = None
            self._w_host[:, lane] = 0.0
            self._intercepts[lane] = 0.0
            self._thresholds[lane] = 0.0
            self._generations[lane] += 1
            self._publish()
        logger.info("serve.tenant_removed %s lane %d", name, lane)
        return displaced

    def swap_model(self, classifier, tenant: Optional[str] = None):
        """Hot-swap one tenant's model; returns the displaced one. The
        replacement must have float32 linear weights of the stack's
        shape; a refused swap leaves the published stack untouched.
        ``tenant`` may be omitted only while one tenant is registered."""
        with self._tenant_lock:
            if tenant is None:
                if len(self._lanes) != 1:
                    raise ValueError(
                        f"{len(self._lanes)} tenants are registered; "
                        f"swap_model needs tenant= to pick one"
                    )
                tenant = next(iter(self._lanes))
            if tenant not in self._lanes:
                raise ValueError(f"unknown tenant {tenant!r}")
            self._require_fused_linear(tenant, classifier)
            shape = engine_mod.weights_of(classifier).shape
            if shape != self._weight_shape:
                raise ValueError(
                    f"hot swap for tenant {tenant!r} requires float32 linear "
                    f"weights of the stack shape {self._weight_shape} (admin "
                    f"builds no kernel and no program); got {shape}"
                )
            lane = self._lanes[tenant]
            displaced = self._classifiers[lane]
            self._write_lane(lane, classifier)
            self._generations[lane] += 1
            self._publish()
        logger.info("serve.tenant_swapped %s lane %d", tenant, lane)
        return displaced

    # -- execution ------------------------------------------------------

    def execute(
        self,
        windows: Sequence[np.ndarray],
        resolutions: np.ndarray,
        tenants: Optional[Sequence[Optional[str]]] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Run one mixed-tenant micro-batch: ``tenants[i]`` names the
        model serving window ``i`` (a None entry, or None for the whole
        batch, means the lowest registered lane). The stack and the
        name -> lane map are read once here; the solo engine's rung
        then calls the tenant-stacked hooks below. A tenant that is not
        registered raises ``batcher.UnknownTenantError`` naming it: the
        batcher fails that tenant's requests alone."""
        self._batch = self._resolve(tenants, len(windows))
        try:
            return super().execute(windows, resolutions)
        finally:
            self._batch = None

    def _resolve(self, tenants, n: int) -> Tuple[TenantStack, np.ndarray]:
        with self._tenant_lock:
            stack = self._stack
            default_lane = min(self._lanes.values())
            if tenants is None:
                return stack, np.full(n, default_lane, np.int32)
            if len(tenants) != n:
                raise ValueError(f"{len(tenants)} tenant ids for {n} windows")
            unknown = {t for t in tenants if t is not None and t not in self._lanes}
            if unknown:
                raise batcher_mod.UnknownTenantError(unknown)
            lanes = np.asarray(
                [default_lane if t is None else self._lanes[t] for t in tenants], np.int32
            )
            return stack, lanes

    def _capacity_lanes(self, lanes: np.ndarray) -> torch.Tensor:
        """The batch's lanes over the whole capacity, on the host; padded
        rows carry lane 0 (their windows are zero, so their margin is
        0.0 whatever the lane)."""
        out = np.zeros(self.capacity, np.int32)
        out[:len(lanes)] = lanes
        return torch.from_numpy(out)

    def _mega_margins(self, windows, res, model=None) -> torch.Tensor:
        """K6: the batch at the padded stride, one copy, one launch, each
        row against its tenant's row of the stack (K6-w8/w4: of the
        packed stack, with its lane's scale). The tenants' models come
        from the batch's stack snapshot, not from ``model``."""
        stack, lanes = self._batch
        staged, lanes_host = self._stage_mega(windows), self._capacity_lanes(lanes)
        if stack.weights_precision != "f32":
            return self._mega_program(staged, res, stack.packed, stack.scales, lanes_host)
        return self._mega_program(staged, res, stack.weights, lanes_host)

    def _fused_margins(self, windows, res, model=None) -> torch.Tensor:
        """The fused ingest kernel's rows, then for every lane present
        the solo fused rung's own ``feats @ weights``, and a per-row
        pick (``serve_mega.lane_margins``); a quantized stack is
        dequantized on the device first, as the JAX package's program
        does."""
        stack, lanes = self._batch
        feats = self._fused_features(self._fused, windows, res)
        return serve_mega.lane_margins(
            feats, self._f32_stack(stack), self._capacity_lanes(lanes).numpy()
        )

    def _f32_stack(self, stack: TenantStack) -> torch.Tensor:
        """The (MAX_TENANTS, C*K) float32 stack a snapshot serves: its
        weights, or its packed payload dequantized on the device."""
        if stack.weights_precision == "f32":
            return stack.weights
        d = self._w_host.shape[0]
        return quant.dequantize_weight_stack(
            stack.packed.t(), stack.scales, stack.weights_precision, d
        ).t().contiguous()

    def _postprocess(self, margins: np.ndarray, model=None):
        """Each row's tenant intercept and threshold: the solo engine's
        float32 add and compare with that tenant's values, so a tenant's
        margins and predictions stay bit-identical to its solo
        engine's."""
        stack, lanes = self._batch
        margins = margins + stack.intercepts[lanes]
        return (margins > stack.thresholds[lanes]).astype(np.float64), margins

    # -- warmup ---------------------------------------------------------

    def warmup(self) -> None:
        """The JAX package's order: the weights gate first
        (:meth:`_weights_quant_warmup`, which publishes the quantized
        stack on a pass), then the solo engine's warmup, whose mega gate
        and program are made at the residency that was published.
        Idempotent."""
        if self._warmed:
            return
        self._weights_quant_warmup()
        super().warmup()

    def _weights_quant_warmup(self) -> None:
        """Promote the requested quantized stack if its margins pass the
        weights gate: the gate windows through the fused rung, their
        lanes cycling over the registered tenants, against the published
        f32 stack and against the quantized current host mirror, at
        ``quant.weights_gate_tolerance`` (``EEG_TPU_WEIGHTS_GATE_TOL=0``
        shuts it). A miss leaves the f32 stack standing and recorded; an
        exception raises, records nothing, and raises again on the next
        warmup."""
        wp = self._weights_precision_requested
        # once decided, never again: a warmup retried after a failed mega
        # gate would otherwise hold the published quantized stack against
        # itself
        if wp == "f32" or self.weights_record is not None:
            return
        windows, res_np = self._gate_windows()
        res = torch.from_numpy(res_np).to(self.device)
        n = len(windows)
        lanes = self._gate_lanes(n)
        with self._tenant_lock:
            f32_stack = self._stack
            packed_np, scales_np = quant.quantize_weight_stack(self._w_host, wp)
            tol = quant.weights_gate_tolerance(wp, self._w_host)
        packed, scales = self._to_device(packed_np, scales_np)
        candidate = f32_stack._replace(weights=None, packed=packed, scales=scales,
                                       weights_precision=wp)
        margins = {}
        for label, stack in (("f32", f32_stack), (wp, candidate)):
            self._batch = (stack, lanes)
            try:
                margins[label] = self._fused_margins(windows, res)[:n].cpu().numpy()
            finally:
                self._batch = None
        dev = float(np.max(np.abs(margins[wp] - margins["f32"]))) if n else 0.0
        gate = {"max_abs_dev": dev, "tolerance": tol, "ok": bool(dev <= tol),
                "rows_checked": n}
        if not gate["ok"]:
            logger.warning(
                "serve.weights_quant_gate refused the %s stack: max abs margin dev "
                "%.3e > gate %.3e; serving the f32 stack", wp, dev, tol,
            )
            self.weights_record = {"requested": wp, "used": "f32", "gate": gate}
            return
        with self._tenant_lock:
            self._weights_precision = wp
            try:
                self._publish()
            except BaseException:
                self._weights_precision = "f32"
                raise
        self.weights_record = {"requested": wp, "used": wp, "gate": gate}
        logger.info("serve.weights_quant promoted %s (%d resident bytes)", wp,
                    self._resident_bytes)

    def _make_mega_program(self, precision: str):
        return serve_mega.make_serve_mega_multi_program(
            wavelet_index=self.wavelet_index, epoch_size=self.epoch_size,
            skip_samples=self.skip_samples, feature_size=self.feature_size,
            n_channels=self.n_channels, pre=self.pre, post=self.post,
            capacity=self.capacity, weights_precision=self._weights_precision,
        )

    def _gate_lanes(self, n: int) -> np.ndarray:
        """Gate-window lanes cycling over the registered tenants, so the
        gate judges the lane pick itself, not lane 0 alone."""
        with self._tenant_lock:
            lanes = sorted(self._lanes.values())
        return np.asarray([lanes[i % len(lanes)] for i in range(n)], np.int32)

    def _mega_warmup(self, precision: str) -> None:
        """The solo engine's gate (multi-mega against multi-fused on the
        gate windows at ``MEGA_GATE_TOL``; a miss raises), with the gate
        windows spread over the registered tenants."""
        windows, _res = self._gate_windows()
        self._batch = (self._stack, self._gate_lanes(len(windows)))
        try:
            super()._mega_warmup(precision)
        finally:
            self._batch = None
            self.mega_record["weights_precision"] = self._weights_precision


class MultiplexedService(service_mod.InferenceService):
    """N tenants' models behind one engine, one batcher and one queue.

    The single-model service's lifecycle (start, drain, stop, watchdog,
    stats) stands; multiplexing adds the tenant key on every request,
    runtime tenant administration (:meth:`add_tenant`,
    :meth:`remove_tenant`, :meth:`swap_tenant`: none builds anything),
    per-tenant attribution in the stats block and the per-tenant
    admission quota (``ServeConfig.tenant_quota``)."""

    def __init__(
        self,
        tenants,
        wavelet_index: int = 8,
        n_channels: int = len(constants.CHANNEL_NAMES),
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        config: Optional[service_mod.ServeConfig] = None,
        engine_rung: str = "auto",
        weights_precision: str = "f32",
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config or service_mod.ServeConfig()
        self._attach(
            MultiplexedEngine(
                tenants,
                wavelet_index=wavelet_index,
                n_channels=n_channels,
                pre=pre,
                post=post,
                capacity=self.config.max_batch,
                engine_rung=engine_rung,
                weights_precision=weights_precision,
                device=device,
            ),
            tenant_aware=True,
            tenant_quota=self.config.tenant_quota,
        )

    @classmethod
    def from_saved(
        cls,
        tenants: Dict[str, Tuple[str, str]],
        warmup: bool = True,
        **kwargs,
    ) -> "MultiplexedService":
        """Load each tenant's saved model once and build the service
        around the stack: ``tenants`` maps tenant name ->
        ``(classifier_name, model_path)``."""
        loaded = {}
        for name, (classifier_name, model_path) in tenants.items():
            classifier = clf_registry.create(classifier_name)
            classifier.load(model_path)
            loaded[name] = classifier
        service = cls(loaded, **kwargs)
        if warmup:
            service.engine.warmup()
        return service

    # -- tenant administration ------------------------------------------

    @property
    def tenants(self) -> Tuple[str, ...]:
        return self.engine.tenants

    def add_tenant(self, name: str, classifier) -> int:
        """Register a tenant at runtime; returns its lane."""
        lane = self.engine.add_tenant(name, classifier)
        self.batcher.count("tenant_adds")
        return lane

    def add_tenant_from_saved(self, name: str, classifier_name: str, model_path: str) -> int:
        """Load a saved model and register it as ``name``."""
        classifier = clf_registry.create(classifier_name)
        classifier.load(model_path)
        return self.add_tenant(name, classifier)

    def remove_tenant(self, name: str):
        """Unregister a tenant and drop its accounting; in-flight
        requests ride the snapshot they started with, new submissions
        for it are refused."""
        displaced = self.engine.remove_tenant(name)
        self.batcher.evict_tenant(name)
        self.batcher.count("tenant_removes")
        return displaced

    def swap_tenant(self, name: str, classifier):
        """Hot-swap one tenant's model; returns the displaced one."""
        displaced = self.engine.swap_model(classifier, tenant=name)
        self.batcher.count("tenant_swaps")
        self.batcher._count_tenant(name, "swaps")
        return displaced

    # -- request path ---------------------------------------------------

    def _submit(self, window, resolutions, deadline_s, block_s, tenant):
        # an unknown tenant is refused at the door, never queued for the
        # engine to refuse later
        if tenant is None:
            raise ValueError(
                "a multiplexed service needs tenant= on every request "
                "(the tenant keys the weight stack's lane)"
            )
        if not self.engine.has_tenant(tenant):
            raise ValueError(
                f"unknown tenant {tenant!r}; registered: {list(self.engine.tenants)}"
            )
        return super()._submit(window, resolutions, deadline_s, block_s, tenant)

    def submit(
        self,
        window: np.ndarray,
        resolutions: np.ndarray,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
        block_s: float = 0.0,
        label: Optional[float] = None,
    ) -> batcher_mod.ServeFuture:
        """Admit one tenant-keyed request; returns its future. A shed
        raises :class:`ShedError` with the structured per-tenant
        evidence on ``.evidence``. A multi-tenant service has no
        lifecycle manager: ``label=`` raises."""
        if label is not None:
            raise ValueError(
                "multiplexed services have no lifecycle manager; "
                "submit(label=) is the solo service's surface"
            )
        return self._submit(window, resolutions, deadline_s, block_s, tenant)

    def predict_window(
        self,
        window: np.ndarray,
        resolutions: np.ndarray,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> batcher_mod.Result:
        """Blocking convenience: tenant-keyed submit and wait."""
        budget = (
            deadline_s if deadline_s is not None else self.config.default_deadline_s
        )
        fut = self.submit(window, resolutions, tenant=tenant, deadline_s=budget)
        return fut.result(timeout=self._result_timeout(budget))

    def predict_all(
        self,
        windows: Sequence[np.ndarray],
        resolutions,
        tenants,
        deadline_s: Optional[float] = None,
    ) -> List[batcher_mod.Result]:
        """Drive a window set through the service with backpressure,
        results in input order. ``tenants`` is one tenant name for all
        windows or one per window; mixed tenants coalesce."""
        if isinstance(tenants, str):
            tenants = [tenants] * len(windows)
        if len(tenants) != len(windows):
            raise ValueError(f"{len(tenants)} tenant ids for {len(windows)} windows")
        return self._predict_all(windows, resolutions, list(tenants), deadline_s)

    # -- observability --------------------------------------------------

    def stats_block(self) -> dict:
        """The solo service's ``serve`` block plus, per tenant, its
        lane, swap generation, outcome counters, latency percentiles and
        SLO scorecard. Safe on a live service."""
        block = super().stats_block()
        counters, _ = self.batcher.snapshot()
        tenant_lat = self.batcher.tenant_latency_snapshot()
        tenant_hists = self.batcher.tenant_histogram_snapshot()
        tenants_block = {}
        for name in self.engine.tenants:
            lat = sorted(tenant_lat.get(name, []))
            info = self.engine.tenant_info(name)

            def count(key, name=name):
                return counters.get(f"tenant.{name}.{key}", 0)

            tenants_block[name] = {
                "lane": info["lane"],
                "generation": info["generation"],
                "swaps": count("swaps"),
                "requests": {
                    key: count(key)
                    for key in ("submitted", "completed", "shed",
                                "deadline_exceeded", "failed", "retries")
                },
                "latency_ms": {
                    "p50": round(service_mod._percentile(lat, 50.0) * 1e3, 3),
                    "p99": round(service_mod._percentile(lat, 99.0) * 1e3, 3),
                    "n": len(lat),
                },
                "slo": metrics_export.slo_block(
                    tenant_hists.get(name, metrics_export.LatencyHistogram()),
                    {key: count(key)
                     for key in ("completed", "shed", "failed", "deadline_exceeded")},
                    objective_ms=self.config.slo_latency_ms,
                    availability_target=self.config.slo_availability_target,
                ),
                # schema-stable with the solo block: the stack's swap
                # generation above is a tenant's model state
                "lifecycle": None,
            }
        block["tenants"] = tenants_block
        block["tenant_quota"] = self.config.tenant_quota
        block["resident_weight_bytes"] = self.engine.resident_weight_bytes
        block["weights_precision"] = self.engine.weights_precision
        if self.engine.weights_record is not None:
            block["weights"] = dict(self.engine.weights_record)
        return block
