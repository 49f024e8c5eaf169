"""Model lifecycle manager for the resident serving service.

Port of the JAX package's ``serve/lifecycle.py``. It closes the
train/serve loop of the P300 speller, where the true target of each
trial is known once the trial ends, with three pieces on one adapter
thread, off the request path:

- **Streaming partial fit.** Labeled feedback
  (``InferenceService.submit(..., label=)`` or ``feedback()``) gathers
  into batches of ``adapt_batch``. Each batch is featurized by the
  engine's own fused rung (:meth:`serve.engine.ServingEngine.featurize`,
  the ingest kernel on the card) and trains a **candidate**, warm-started
  from the live weights, through ``models/sgd.partial_fit_linear``:
  ``adapt_iters`` iterations with absolute indices over a fixed-capacity
  feedback ring with a sample mask. The ring is host numpy, the
  checkpoint state; each chunk copies the ring, its labels and its mask
  to the engine's device and runs there. Every committed chunk's state
  (weights and the ring it trained on) is checkpointed
  (``checkpoint/manager.py``), so an adapter killed mid-stream resumes
  from its latest checkpoint and replays the rest of the feedback to the
  same candidate weights.

- **Shadow-scored hot swap with rollback.** Both models' decisions on
  each feedback batch feed one :class:`models.stats.WindowedStatistics`
  each; the candidate is judged on the batch before it trains on it.
  When both windows are full and the candidate's expected cost is at
  most the live model's times the ``swap_gate=`` ratio,
  :meth:`serve.engine.ServingEngine.swap_model` installs it (one copy of
  the weights; no kernel is built). The displaced model is kept: if the
  promoted model's windowed cost regresses past the live model's
  pre-swap record, it is rolled back. A candidate that never passes the
  gate leaves serving exactly as it would be without one.

- **Drift detection.** The live model's windowed expected cost is held
  against the baseline of its first full window; past ``drift_factor``
  it counts ``serve.drift`` and records an event, at most once per
  window span.

Injection points ``serve.adapt`` (one partial-fit chunk) and
``serve.swap`` (one promotion attempt) fire into the adapter's retry
machinery: a failed chunk retries the same batch (then drops it,
counted), and a failed swap leaves the live model untouched with the
candidate kept. States: ``live`` -> feedback -> ``adapting`` (a
candidate staged and shadow-scored) -> promoted (previous model kept) ->
rolled back on regression; a wedged adapter step (the watchdog)
discards the candidate while serving continues.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import os
import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .batcher import ServiceClosedError
from .engine import weights_of
from ..models import linear, sgd
from ..models import stats as stats_mod
from ..obs import chaos, domain as run_domain, events
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def parse_swap_gate(value: str):
    """``swap_gate=`` grammar -> ``(mode, ratio)``.

    ``off`` disables promotion (shadow scoring only); ``cost`` promotes
    when the candidate's windowed expected cost is at most the live
    model's; ``cost:<ratio>`` scales that bar (above 1 permissive, below
    1 strict). Anything else raises ``ValueError``: a mistyped gate must
    never promote."""
    if value == "off":
        return ("off", None)
    head, sep, tail = value.partition(":")
    if head != "cost":
        raise ValueError(
            f"swap_gate= must be 'off' or 'cost[:<ratio>]', got {value!r}"
        )
    if not sep:
        return ("cost", 1.0)
    try:
        ratio = float(tail)
    except ValueError:
        raise ValueError(f"swap_gate= ratio must be a float, got {tail!r}")
    if not ratio > 0.0:
        raise ValueError(f"swap_gate= ratio must be > 0, got {ratio}")
    return ("cost", ratio)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Lifecycle knobs; all bounded, all recorded in the block."""

    #: feedback items per partial-fit batch (one chunk per batch)
    adapt_batch: int = 16
    #: SGD iterations per chunk (indices continue across chunks)
    adapt_iters: int = 20
    #: row capacity of the feedback ring (the oldest rows are overwritten)
    capacity: int = 1024
    #: outcomes per windowed-statistics window (gate and drift currency)
    drift_window: int = 64
    #: the parsed ``swap_gate=`` policy
    gate_mode: str = "cost"
    gate_ratio: Optional[float] = 1.0
    #: windowed-cost degradation factor that fires ``serve.drift``
    drift_factor: float = 1.5
    #: candidate checkpoint and promotion directory (None: in memory
    #: only, no resume)
    checkpoint_dir: Optional[str] = None
    #: misclassification costs of the windowed statistics
    cost_fp: float = 1.0
    cost_fn: float = 1.0
    #: an adapter busy with one step for this long is declared wedged;
    #: the candidate is discarded and serving continues. The kernels are
    #: built at the service's warmup, before the adapter starts, so a
    #: step never waits on a build
    watchdog_s: float = 120.0
    #: attempts at a failed partial-fit chunk before its batch is dropped
    max_attempts: int = 3
    #: bounded feedback queue (the oldest item is dropped past it, counted)
    queue_depth: int = 4096
    #: roll a promoted model back when its windowed cost regresses past
    #: the pre-swap record
    rollback: bool = True

    @classmethod
    def from_query_map(cls, query_map, cost_fp: float = 1.0,
                       cost_fn: float = 1.0) -> "LifecycleConfig":
        """The ``adapt=`` family: ``swap_gate=``, ``drift_window=``,
        ``adapt_batch=``, ``adapt_iters=`` and ``checkpoint_path=`` (the
        adapter's resume directory), with the JAX package's messages."""

        def _int(name, default, floor=1):
            value = query_map.get(name, "")
            if not value:
                return default
            try:
                n = int(value)
            except ValueError:
                raise ValueError(
                    f"query parameter {name}= must be an integer, got {value!r}"
                )
            if n < floor:
                raise ValueError(f"{name}= must be >= {floor}, got {n}")
            return n

        gate_mode, gate_ratio = parse_swap_gate(query_map.get("swap_gate") or "cost")
        return cls(
            adapt_batch=_int("adapt_batch", 16),
            adapt_iters=_int("adapt_iters", 20),
            drift_window=_int("drift_window", 64),
            gate_mode=gate_mode,
            gate_ratio=gate_ratio,
            checkpoint_dir=query_map.get("checkpoint_path") or None,
            cost_fp=float(cost_fp),
            cost_fn=float(cost_fn),
        )


class _Candidate:
    """One staged candidate generation: its chunk carry, the feedback
    ring it trains on, and its shadow window."""

    def __init__(self, d: int, config: LifecycleConfig, live_weights, generation: int):
        self.d = int(d)
        self.generation = int(generation)
        self.w = (
            np.zeros((self.d,), np.float32) if live_weights is None
            else np.array(live_weights, np.float32)
        )
        self.converged = False
        self.n_updates = 0
        #: absolute iteration index (the trajectory position)
        self.t = 0
        self.features = np.zeros((config.capacity, d), np.float32)
        self.labels = np.zeros((config.capacity,), np.float32)
        self.mask = np.zeros((config.capacity,), np.float32)
        self.rows_seen = 0
        self.batches = 0
        self.window = stats_mod.WindowedStatistics(
            config.drift_window, cost_fp=config.cost_fp, cost_fn=config.cost_fn,
        )

    # -- checkpoint state -------------------------------------------------

    def state(self) -> dict:
        return {
            "w": self.w,
            "converged": np.asarray(self.converged),
            "n_updates": np.asarray(self.n_updates, np.int32),
            "t": np.asarray(self.t, np.int64),
            "features": self.features,
            "labels": self.labels,
            "mask": self.mask,
            "rows_seen": np.asarray(self.rows_seen, np.int64),
        }

    def adopt(self, state: dict, batches: int, generation: int) -> None:
        self.w = np.asarray(state["w"], np.float32)
        self.converged = bool(state["converged"])
        self.n_updates = int(state["n_updates"])
        self.t = int(state["t"])
        self.features = np.asarray(state["features"], np.float32)
        self.labels = np.asarray(state["labels"], np.float32)
        self.mask = np.asarray(state["mask"], np.float32)
        self.rows_seen = int(state["rows_seen"])
        self.batches = int(batches)
        self.generation = int(generation)

    def block(self) -> dict:
        return {
            "generation": self.generation,
            "batches": self.batches,
            "t": self.t,
            "rows": min(self.rows_seen, len(self.mask)),
            "window": self.window.summary(),
        }


class LifecycleManager:
    """Streaming partial fit, shadow-scored hot swap and drift detection
    for one :class:`~serve.engine.ServingEngine`.

    ``featurize`` defaults to the engine's
    :meth:`~serve.engine.ServingEngine.featurize`, so feedback rows come
    from the computation that serves traffic; tests inject a pure
    function. The partial-fit chunks run on ``device``: the engine's
    device by default (``None`` with no engine means ``cuda`` and raises
    without a card).
    """

    def __init__(
        self,
        engine,
        config: Optional[LifecycleConfig] = None,
        featurize: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.engine = engine
        self.config = config or LifecycleConfig()
        self._featurize = featurize or (engine.featurize if engine is not None else None)
        if self._featurize is None:
            raise ValueError(
                "lifecycle needs an engine or an explicit featurize callable"
            )
        self.device = (
            engine.device if engine is not None and device is None
            else resolve_device(device)
        )
        live = engine.classifier if engine is not None else None
        if live is not None and not isinstance(live, linear._LinearClassifier):
            raise ValueError(
                "lifecycle adaptation trains the linear family (logreg/svm); "
                f"{type(live).__name__} has no partial-fit surface"
            )
        self._sgd_config = self._resolve_sgd_config(live)
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._pending = None  # (items, attempts): a batch to retry
        self._processing = False
        self._stop = threading.Event()
        self._flush_requested = threading.Event()
        self.wedged = threading.Event()
        self._closed = False
        self._heartbeat = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

        self.counters = collections.Counter()
        self.generation = 0
        self.candidate: Optional[_Candidate] = None
        self.live_window = stats_mod.WindowedStatistics(
            self.config.drift_window, cost_fp=self.config.cost_fp,
            cost_fn=self.config.cost_fn,
        )
        #: the first full window's cost: the drift reference
        self.baseline_cost: Optional[float] = None
        self._last_drift_at = 0
        self.last_gate: Optional[dict] = None
        #: (classifier, pre-swap windowed cost) kept for rollback
        self._previous = None
        self.promoted_path: Optional[str] = None
        self._manager = None
        if self.config.checkpoint_dir:
            from ..checkpoint.manager import CheckpointManager

            self._manager = CheckpointManager(
                os.path.join(self.config.checkpoint_dir, "candidate"), max_to_keep=2,
            )
            self._try_resume()

    @staticmethod
    def _resolve_sgd_config(live) -> sgd.SGDConfig:
        """The live model's own hyperparameters with the early stop off: a
        carried ``converged`` flag would freeze the candidate on its first
        quiet window and it could never adapt again."""
        base = live._sgd_config() if live is not None else sgd.SGDConfig()
        return dataclasses.replace(base, convergence_tol=0.0)

    # -- resume -----------------------------------------------------------

    def _try_resume(self) -> None:
        """Adopt the latest checkpointed candidate trajectory."""
        step = self._manager.latest_step()
        if step is None:
            return
        extra = self._manager.read_metadata(step).get("extra", {})
        generation = int(extra.get("generation", 0))
        cand = _Candidate(int(extra["d"]), self.config, None, generation)
        state, _ = self._manager.restore(cand.state(), step=step)
        cand.adopt(state, batches=int(extra.get("batches", step)), generation=generation)
        self.candidate = cand
        self.generation = cand.generation
        logger.info(
            "lifecycle resumed candidate g%d at t=%d (%d batches) from %s",
            cand.generation, cand.t, cand.batches, self._manager.directory,
        )

    @property
    def batches_trained(self) -> int:
        return self.candidate.batches if self.candidate else 0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "LifecycleManager":
        if self._thread is not None:
            return self
        domain = run_domain.current()

        def adopted(body):
            def run():
                with run_domain.activate(domain):
                    body()
            return run

        self._thread = threading.Thread(
            target=adopted(self._run), name="eeg-serve-adapter", daemon=True,
        )
        self._thread.start()
        self._watchdog_thread = threading.Thread(
            target=adopted(self._watchdog_run), name="eeg-serve-adapter-watchdog",
            daemon=True,
        )
        self._watchdog_thread.start()
        return self

    def close(self, flush: bool = True, timeout_s: float = 10.0) -> None:
        """Stop adapting. With ``flush`` the queued feedback (a final
        partial batch included) is processed first, bounded by
        ``timeout_s``. Idempotent; feedback after close raises
        :class:`~serve.batcher.ServiceClosedError`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if flush and not self.wedged.is_set():
            self.flush(timeout_s=timeout_s)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in (self._thread, self._watchdog_thread):
            if t is not None:
                t.join(timeout=5.0)

    # -- feedback ---------------------------------------------------------

    def feedback(self, window, resolutions, label) -> bool:
        """One labeled served outcome. True when queued; False when
        dropped (a wedged adapter or a full queue, counted). Raises after
        :meth:`close`."""
        if self._closed:
            raise ServiceClosedError(
                "lifecycle is closed; feedback is not accepted (draining or stopped)"
            )
        self._count("feedback")
        if self.wedged.is_set():
            self._count("feedback_dropped")
            return False
        item = (
            np.array(window, copy=True),
            np.asarray(resolutions, np.float32).copy(),
            float(label),
        )
        with self._cond:
            if len(self._queue) >= self.config.queue_depth:
                self._queue.popleft()
                self._count("feedback_dropped")
            self._queue.append(item)
            self._cond.notify()
        return True

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued item (a final partial batch included)
        has been processed. True when idle; False when the timeout or a
        wedge cut the wait."""
        self._flush_requested.set()
        with self._cond:
            self._cond.notify_all()
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                if self.wedged.is_set():
                    return False
                with self._cond:
                    idle = not self._queue and self._pending is None and not self._processing
                if idle:
                    return True
                time.sleep(0.005)
            return False
        finally:
            self._flush_requested.clear()

    # -- the adapter loop -------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        from .. import obs

        with self._lock:
            self.counters[key] += n
        obs.metrics.count(f"serve.{key}", n)

    def _next_batch(self, wait_s: float):
        """The next batch: a pending retry first, else a full
        ``adapt_batch``, else (under flush) the remainder."""
        with self._cond:
            if self._pending is not None:
                items, attempts = self._pending
                self._pending = None
                self._processing = True
                return items, attempts
            want = self.config.adapt_batch
            if len(self._queue) < want and not (
                self._flush_requested.is_set() and self._queue
            ):
                self._cond.wait(wait_s)
            if not self._queue:
                return None, 0
            if len(self._queue) < want and not self._flush_requested.is_set():
                return None, 0
            take = min(want, len(self._queue))
            items = [self._queue.popleft() for _ in range(take)]
            self._processing = True
            return items, 0

    def _run(self) -> None:
        while not self._stop.is_set():
            self._heartbeat = time.monotonic()
            items, attempts = self._next_batch(wait_s=0.05)
            if items is None:
                with self._cond:
                    self._processing = False
                continue
            try:
                self._process_batch(items, attempts)
            finally:
                with self._cond:
                    self._processing = False
                if self.wedged.is_set():
                    return

    def _process_batch(self, items, attempts: int) -> None:
        """One partial-fit chunk over one feedback batch: injection
        point, featurize, train (committed all or nothing), checkpoint,
        then score, gate and drift. A failure before the commit retries
        the same batch (bounded), so the trajectory is the same when the
        retry lands."""
        self._heartbeat = time.monotonic()
        try:
            chaos.maybe_fire("serve.adapt")
            t0 = time.perf_counter()
            feats = self._featurize_batch(items)
            t1 = time.perf_counter()
            labels = np.asarray([y for _w, _res, y in items], np.float32)
            live = self.engine.classifier if self.engine else None
            cand = self.candidate
            if cand is None:
                cand = _Candidate(
                    feats.shape[1], self.config,
                    weights_of(live) if live is not None else None, self.generation,
                )
            if feats.shape[1] != cand.d:
                raise ValueError(
                    f"feedback features are {feats.shape[1]}-d but the "
                    f"candidate trains {cand.d}-d rows"
                )
            # the candidate is scored on the batch before it trains on it
            cand_w_before = cand.w
            new_state = self._train_chunk(cand, feats, labels)
            t2 = time.perf_counter()
        except Exception as e:
            self._count("adapt_failures")
            events.event(
                "serve.adapt_failed", attempt=attempts + 1,
                error=f"{type(e).__name__}: {e}",
            )
            if attempts + 1 >= self.config.max_attempts:
                self._count("adapt_dropped")
                logger.error(
                    "lifecycle dropped a feedback batch after %d attempts (%s: %s)",
                    attempts + 1, type(e).__name__, e,
                )
                return
            with self._cond:
                self._pending = (items, attempts + 1)
            return
        if self.wedged.is_set():
            # the watchdog discarded this adapter's candidate while the
            # step stalled: a late wake-up must not commit it again
            return
        self.candidate = cand
        cand.adopt(new_state, batches=cand.batches + 1, generation=cand.generation)
        self._count("adapt_batches")
        self._checkpoint(cand)
        # the step's host seconds: the chunk's include the ring's copy to
        # the device and the weights' copy back
        events.event(
            "serve.adapt_chunk", t=cand.t, batch=cand.batches,
            generation=cand.generation, rows=len(items), featurize_s=t1 - t0,
            chunk_s=t2 - t1, checkpoint_s=time.perf_counter() - t2,
        )
        self._score(feats, labels, cand_w_before)
        # rollback before promotion: a regressed promoted model is
        # restored before a new candidate may go on top of it
        self._maybe_rollback()
        self._maybe_promote()
        self._maybe_drift()

    def _featurize_batch(self, items) -> np.ndarray:
        """Featurize one batch in runs of equal per-channel resolutions
        (a batch may straddle a recording boundary; one call scales by
        one resolution vector)."""
        rows = []
        start = 0
        while start < len(items):
            res = items[start][1]
            end = start
            while end < len(items) and np.array_equal(items[end][1], res):
                end += 1
            rows.append(np.asarray(
                self._featurize([w for w, _res, _y in items[start:end]], res), np.float32,
            ))
            start = end
        return np.concatenate(rows, axis=0)

    def _train_chunk(self, cand: _Candidate, feats, labels) -> dict:
        """Write the batch into a copy of the candidate's ring and run one
        chunk on the device; returns the would-be state (the caller
        commits it)."""
        features = cand.features.copy()
        lab = cand.labels.copy()
        mask = cand.mask.copy()
        rows_seen = cand.rows_seen
        cap = features.shape[0]
        for i in range(feats.shape[0]):
            slot = rows_seen % cap
            features[slot] = feats[i]
            lab[slot] = labels[i]
            mask[slot] = 1.0
            rows_seen += 1
        w, converged, n_updates = sgd.partial_fit_linear(
            (cand.w, cand.converged, cand.n_updates), cand.t, features, lab,
            self._sgd_config, self.config.adapt_iters, sample_mask=mask,
            device=self.device,
        )
        self._count("adapt_chunks")
        return {
            "w": w.cpu().numpy().astype(np.float32, copy=False),
            "converged": np.asarray(bool(converged)),
            "n_updates": np.asarray(int(n_updates), np.int32),
            "t": np.asarray(cand.t + self.config.adapt_iters, np.int64),
            "features": features,
            "labels": lab,
            "mask": mask,
            "rows_seen": np.asarray(rows_seen, np.int64),
        }

    def _checkpoint(self, cand: _Candidate) -> None:
        if self._manager is None:
            return
        try:
            self._manager.save(
                cand.batches, cand.state(),
                extra={"d": cand.d, "batches": cand.batches, "generation": cand.generation},
            )
        except OSError as e:
            # a full disk degrades resume, never adaptation
            self._count("checkpoint_failures")
            logger.warning("lifecycle checkpoint failed: %s", e)

    # -- scoring / gate / drift -------------------------------------------

    @staticmethod
    def _decide(feats, weights, intercept, threshold) -> np.ndarray:
        margins = feats @ np.asarray(weights, np.float32) + intercept
        return (margins > threshold).astype(np.float64)

    def _score(self, feats, labels, cand_w_before) -> None:
        live = self.engine.classifier if self.engine else None
        if live is not None:
            live_preds = self._decide(
                feats, weights_of(live), live.model.intercept, live.margin_threshold,
            )
            for p, y in zip(live_preds, labels):
                self.live_window.add(p, y)
        cand = self.candidate
        if cand is not None:
            threshold = live.margin_threshold if live is not None else 0.0
            for p, y in zip(self._decide(feats, cand_w_before, 0.0, threshold), labels):
                cand.window.add(p, y)

    def _maybe_promote(self) -> None:
        cand = self.candidate
        if (
            cand is None
            or self.config.gate_mode == "off"
            or self.engine is None
            or self.wedged.is_set()
        ):
            return
        if not (cand.window.full and self.live_window.full):
            return
        live_cost = self.live_window.expected_cost()
        cand_cost = cand.window.expected_cost()
        ok = (
            not math.isnan(live_cost)
            and not math.isnan(cand_cost)
            and cand_cost <= live_cost * self.config.gate_ratio
        )
        self.last_gate = {
            "candidate_cost": round(cand_cost, 6),
            "live_cost": round(live_cost, 6),
            "ratio": self.config.gate_ratio,
            "promote": bool(ok),
            "generation": cand.generation,
        }
        if ok:
            self._attempt_swap(cand)

    def _attempt_swap(self, cand: _Candidate) -> None:
        """One promotion attempt (the ``serve.swap`` injection point). A
        failure leaves the live model untouched and the candidate kept;
        the gate tries again after the next batch."""
        live = self.engine.classifier
        try:
            chaos.maybe_fire("serve.swap")
            clone = self._clone_with_weights(live, cand.w, live.margin_threshold)
            promoted_path = None
            if self.config.checkpoint_dir:
                promoted_path = os.path.join(self.config.checkpoint_dir, "promoted")
                # load_clf= of this file predicts what the swapped service
                # serves
                clone.save(promoted_path)
            previous = self.engine.swap_model(clone)
        except Exception as e:
            self._count("swap_failures")
            events.event(
                "serve.swap_failed", generation=cand.generation,
                error=f"{type(e).__name__}: {e}",
            )
            logger.warning(
                "lifecycle promotion attempt failed (%s: %s); live model "
                "untouched, candidate retained", type(e).__name__, e,
            )
            return
        self._previous = (previous, self.live_window.expected_cost())
        self.promoted_path = promoted_path + ".npz" if promoted_path else None
        self._count("swaps")
        events.event(
            "serve.promoted", generation=cand.generation,
            candidate_cost=self.last_gate["candidate_cost"],
            live_cost=self.last_gate["live_cost"],
        )
        logger.info(
            "lifecycle promoted candidate g%d (windowed cost %.4f vs live %.4f)",
            cand.generation, self.last_gate["candidate_cost"], self.last_gate["live_cost"],
        )
        # the promoted trajectory's checkpoints are superseded: the disk
        # holds the live and candidate pair, never the swap history
        if self._manager is not None:
            self._manager.clear()
        self.generation += 1
        self.candidate = None
        # the promoted model earns its own windowed record
        self.live_window.reset()

    @staticmethod
    def _clone_with_weights(live, weights, margin_threshold):
        """A classifier of the live model's class carrying ``weights``:
        natively trained linear semantics (no intercept), with the
        serving threshold carried over so a recall-tuned service stays
        tuned across a swap."""
        clone = type(live)()
        clone.set_config(dict(live.config))
        clone.model = linear.LinearModel(
            torch.from_numpy(np.array(weights, np.float32)), 0.0
        )
        clone.margin_threshold = float(margin_threshold)
        return clone

    def _maybe_rollback(self) -> None:
        if (
            self._previous is None
            or not self.config.rollback
            or self.engine is None
            or self.wedged.is_set()
        ):
            return
        if not self.live_window.full:
            return
        previous, pre_swap_cost = self._previous
        cost = self.live_window.expected_cost()
        if math.isnan(cost) or math.isnan(pre_swap_cost):
            return
        if cost <= pre_swap_cost * (self.config.gate_ratio or 1.0):
            # the promoted model held its promise over a full window: the
            # rollback disarms
            self._previous = None
            return
        self.engine.swap_model(previous)
        self._previous = None
        self._count("rollbacks")
        events.event(
            "serve.rollback", post_swap_cost=round(cost, 6),
            pre_swap_cost=round(pre_swap_cost, 6),
        )
        logger.warning(
            "lifecycle ROLLED BACK the promoted model: windowed cost %.4f "
            "regressed past the pre-swap record %.4f", cost, pre_swap_cost,
        )
        self.live_window.reset()

    def _maybe_drift(self) -> None:
        if not self.live_window.full:
            return
        cost = self.live_window.expected_cost()
        if math.isnan(cost):
            return
        if self.baseline_cost is None:
            self.baseline_cost = cost
            return
        if self.live_window.seen - self._last_drift_at < self.config.drift_window:
            return  # at most one firing per window span
        bar = max(self.baseline_cost * self.config.drift_factor, self.baseline_cost + 0.01)
        if cost <= bar:
            return
        self._last_drift_at = self.live_window.seen
        self._count("drift")
        events.event(
            "serve.drift", cost=round(cost, 6), baseline=round(self.baseline_cost, 6),
            window=self.config.drift_window,
        )
        logger.warning(
            "serve.drift: windowed expected cost %.4f exceeds the baseline %.4f "
            "(factor %.2f over window %d); recalibration advised", cost,
            self.baseline_cost, self.config.drift_factor, self.config.drift_window,
        )

    # -- the adapter watchdog ---------------------------------------------

    def _watchdog_run(self) -> None:
        poll = max(0.01, self.config.watchdog_s / 4.0)
        while not self._stop.is_set():
            # a stop-interruptible sleep: close() does not wait out a poll
            if self._stop.wait(poll):
                return
            with self._cond:
                busy = self._processing
            age = time.monotonic() - self._heartbeat
            if busy and age > self.config.watchdog_s:
                # the wedged thread may never return: the candidate is
                # discarded here so a late wake-up cannot promote it, and
                # before ``wedged`` is set, so whoever waits on it reads
                # the discarded state
                self.candidate = None
                with self._cond:
                    self._queue.clear()
                self.wedged.set()
                self._count("lifecycle_wedged")
                events.event("serve.lifecycle_wedged", heartbeat_age_s=round(age, 2))
                logger.error(
                    "lifecycle adapter wedged (heartbeat %.1fs old); candidate "
                    "discarded, live serving continues", age,
                )
                return

    # -- observability ----------------------------------------------------

    @property
    def state(self) -> str:
        if self.wedged.is_set():
            return "wedged"
        if self._closed:
            return "closed"
        if self.candidate is not None:
            return "adapting"
        return "live"

    def block(self) -> dict:
        """The ``lifecycle`` block of the service's stats."""
        with self._lock:
            counters = dict(self.counters)
        # one read: the adapter clears self.candidate on promotion
        cand = self.candidate
        return {
            "enabled": True,
            "state": self.state,
            "generation": self.generation,
            "config": {
                "adapt_batch": self.config.adapt_batch,
                "adapt_iters": self.config.adapt_iters,
                "capacity": self.config.capacity,
                "drift_window": self.config.drift_window,
                "swap_gate": (
                    "off" if self.config.gate_mode == "off"
                    else f"cost:{self.config.gate_ratio}"
                ),
                "drift_factor": self.config.drift_factor,
            },
            "feedback": {
                "received": counters.get("feedback", 0),
                "dropped": counters.get("feedback_dropped", 0),
                "batches": counters.get("adapt_batches", 0),
                "chunks": counters.get("adapt_chunks", 0),
                "failures": counters.get("adapt_failures", 0),
                "dropped_batches": counters.get("adapt_dropped", 0),
            },
            "candidate": None if cand is None else cand.block(),
            "live_window": self.live_window.summary(),
            "baseline_cost": (
                None if self.baseline_cost is None else round(self.baseline_cost, 6)
            ),
            "gate": self.last_gate,
            "swaps": counters.get("swaps", 0),
            "swap_failures": counters.get("swap_failures", 0),
            "rollbacks": counters.get("rollbacks", 0),
            "rollback_armed": self._previous is not None,
            "drift_events": counters.get("drift", 0),
            "promoted_path": self.promoted_path,
            "checkpoint": (
                None if self._manager is None else {
                    "dir": self._manager.directory,
                    "steps": len(self._manager.all_steps()),
                }
            ),
            "wedged": self.wedged.is_set(),
        }
