"""Population training: folds x seeds x a hyperparameter grid.

Port of the JAX package's ``models/population.py``. A population is the
cartesian expansion of

    feature configs         (``fe_sweep=a|b``, the seizure workload,
                             linear family only)
  x cross-validation folds (``cv=k``, k-fold or Monte-Carlo ``cv_mode=mc``)
  x init/sampling seeds   (``seeds=m``: the base seed, base+1, ...)
  x a hyperparameter grid (``sweep=lr:0.1,0.03;reg:0.0,0.01``)

trained by the batched engines of ``parallel/population.py`` (the
default, ``population_mode=vmap``) or one member at a time
(``population_mode=looped``, and the fallback for members the batched
engines cannot express: ``PopulationVmapUnsupported``, logged and
counted as ``population.fallback_looped``; nothing else is caught).
Given a device mesh (``devices=``/``mesh_axes=``), a linear population in
``vmap`` mode trains sharded (``train_linear_population_sharded``: the
member axis over :func:`member_mesh_axis`); nn and ``looped`` populations
keep the JAX package's single-device rule (``population.mesh_unsupported_family``).
A failed sharded training raises: the JAX package's
``population.mesh_fallback`` to one device is not ported.

``cv=1`` is the reference's seed-1 shuffle and 70/30 split, so
``cv=1&seeds=1`` without a sweep is the plain ``train_clf=`` run;
``cv=k`` cuts the seed-1 shuffled order into k contiguous test blocks;
``cv_mode=mc`` draws k shuffle+70/30 splits from seeds 1..k (fold 0 is
the plain split). Members test through the same ``test_features`` call
the sequential runs use; ``models.stats.PopulationStatistics`` carries
the per-member table and the cross-member summary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import stats
from .linear import LinearModel
from ..utils import java_compat

logger = logging.getLogger(__name__)

#: classifier names whose training the population engines can stack on a
#: member axis; tree growers train once per run
SGD_FAMILY = ("logreg", "svm", "nn")

#: sweep axes the grammar accepts (lr: step size / learning rate, reg:
#: L2 regularization, linear family only; cost_fp/cost_fn: class weights,
#: cost_fn the positive class's, linear family only)
_SWEEP_AXES = ("lr", "reg", "cost_fp", "cost_fn")


def parse_sweep(spec: str) -> Tuple[Tuple[str, Tuple[float, ...]], ...]:
    """``lr:0.1,0.03;reg:0.0,0.01`` -> (("lr", (0.1, 0.03)), ...), axes in
    the spec's order; an unknown or repeated axis, a non-numeric value and
    a repeated value raise the JAX package's messages."""
    axes: List[Tuple[str, Tuple[float, ...]]] = []
    seen = set()
    for part in spec.split(";"):
        if not part:
            continue
        name, sep, values = part.partition(":")
        name = name.strip()
        if not sep or name not in _SWEEP_AXES:
            raise ValueError(
                f"sweep= axis must be one of {'/'.join(_SWEEP_AXES)} "
                f"(axis:v1,v2;...), got {part!r}"
            )
        if name in seen:
            raise ValueError(f"sweep= axis {name!r} given twice")
        seen.add(name)
        try:
            vals = tuple(float(v) for v in values.split(",") if v != "")
        except ValueError:
            raise ValueError(f"sweep= axis {name!r} has a non-numeric value in {values!r}")
        if not vals:
            raise ValueError(f"sweep= axis {name!r} has no values")
        if len(set(vals)) != len(vals):
            raise ValueError(f"sweep= axis {name!r} repeats a value: {values!r}")
        axes.append((name, vals))
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """The population axes one run requested."""

    cv: int = 1
    cv_mode: str = "kfold"  # "kfold" | "mc"
    seeds: int = 1
    sweep: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()
    mode: str = "vmap"  # "vmap" | "looped"
    #: the seizure workload's feature-config axis (``fe_sweep=``, ``fe=``
    #: grammar strings): every member trains on its config's matrix
    fe_configs: Tuple[str, ...] = ()

    @classmethod
    def from_query_map(cls, query_map: Dict[str, str]) -> "PopulationSpec":
        def _int(name, default):
            value = query_map.get(name, "")
            if not value:
                return default
            try:
                return int(value)
            except ValueError:
                raise ValueError(f"query parameter {name}= must be an integer, got {value!r}")

        spec = cls(
            cv=_int("cv", 1),
            cv_mode=query_map.get("cv_mode", "") or "kfold",
            seeds=_int("seeds", 1),
            sweep=parse_sweep(query_map.get("sweep", "")),
            mode=query_map.get("population_mode", "") or "vmap",
            fe_configs=tuple(s for s in query_map.get("fe_sweep", "").split("|") if s),
        )
        if len(set(spec.fe_configs)) != len(spec.fe_configs):
            raise ValueError(
                "fe_sweep= repeats a feature config; duplicate members "
                "would train the same model twice"
            )
        if spec.cv < 1:
            raise ValueError("cv= must be >= 1")
        if spec.seeds < 1:
            raise ValueError("seeds= must be >= 1")
        if spec.cv_mode not in ("kfold", "mc"):
            raise ValueError(f"cv_mode= must be kfold or mc, got {spec.cv_mode!r}")
        if spec.mode not in ("vmap", "looped"):
            raise ValueError(f"population_mode= must be vmap or looped, got {spec.mode!r}")
        return spec

    @property
    def active(self) -> bool:
        """True when the run asked for more than the plain split's one
        model: SGD-family training then runs as a population."""
        return self.cv > 1 or self.seeds > 1 or bool(self.sweep) or bool(self.fe_configs)

    def axis_values(self, axis: str) -> Optional[Tuple[float, ...]]:
        for name, values in self.sweep:
            if name == axis:
                return values
        return None

    def grid_points(self) -> int:
        points = 1
        for _, values in self.sweep:
            points *= len(values)
        return points

    def describe(self) -> Dict:
        out = {
            "folds": self.cv,
            "cv_mode": self.cv_mode if self.cv > 1 else "plain_split",
            "seeds": self.seeds,
            "grid": {name: list(values) for name, values in self.sweep},
            "grid_points": self.grid_points(),
        }
        if self.fe_configs:
            out["fe_configs"] = list(self.fe_configs)
        return out


def folds_for(spec: PopulationSpec, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train rows, test rows) per fold as int64 arrays of row indices."""

    def _as_fold(train, test):
        return np.asarray(train, dtype=np.int64), np.asarray(test, dtype=np.int64)

    if spec.cv <= 1:
        return [_as_fold(*java_compat.train_test_split_indices(n, seed=1))]
    if spec.cv > n:
        raise ValueError(f"cv={spec.cv} exceeds the {n} available rows")
    if spec.cv_mode == "mc":
        return [_as_fold(*java_compat.train_test_split_indices(n, seed=1 + i))
                for i in range(spec.cv)]
    perm = java_compat.java_shuffle_indices(n, seed=1)
    k = spec.cv
    bounds = [i * n // k for i in range(k + 1)]
    return [
        _as_fold(perm[: bounds[i]] + perm[bounds[i + 1]:], perm[bounds[i]: bounds[i + 1]])
        for i in range(k)
    ]


@dataclasses.dataclass(frozen=True)
class Member:
    """One member: a fold, a seed and grid overrides (None = the
    classifier config's base value); ``fe`` indexes the spec's
    ``fe_configs`` when the feature-config axis rides along."""

    fold: int
    seed: int
    lr: Optional[float] = None
    reg: Optional[float] = None
    cost_fp: Optional[float] = None
    cost_fn: Optional[float] = None
    fe: Optional[int] = None

    @property
    def label(self) -> str:
        out = f"f{self.fold}.s{self.seed}"
        if self.fe is not None:
            out = f"fe{self.fe}." + out
        if self.lr is not None:
            out += f".lr{self.lr:g}"
        if self.reg is not None:
            out += f".reg{self.reg:g}"
        if self.cost_fp is not None:
            out += f".cfp{self.cost_fp:g}"
        if self.cost_fn is not None:
            out += f".cfn{self.cost_fn:g}"
        return out


def expand_members(spec: PopulationSpec, n_folds: int, base_seed: int, supports_reg: bool,
                   name: str = "", supports_cost: bool = True) -> List[Member]:
    """The member list, feature-config-major, then fold, then seed, then
    grid: the order every engine and report keeps. Axes a family cannot
    express collapse onto the base config with a log line (the network
    has no ``reg`` and no per-member class weights)."""
    lrs: Sequence[Optional[float]] = spec.axis_values("lr") or (None,)
    regs: Sequence[Optional[float]] = spec.axis_values("reg") or (None,)
    cfps: Sequence[Optional[float]] = spec.axis_values("cost_fp") or (None,)
    cfns: Sequence[Optional[float]] = spec.axis_values("cost_fn") or (None,)
    if not supports_reg and spec.axis_values("reg") is not None:
        logger.warning(
            "sweep axis reg does not apply to %s; collapsing %d grid "
            "points onto the base config", name, len(regs),
        )
        regs = (None,)
    if not supports_cost and (spec.axis_values("cost_fp") is not None
                              or spec.axis_values("cost_fn") is not None):
        logger.warning(
            "sweep axes cost_fp/cost_fn do not apply to %s; collapsing "
            "%d grid points onto the base config", name, len(cfps) * len(cfns),
        )
        cfps = cfns = (None,)
    fes: Sequence[Optional[int]] = (
        tuple(range(len(spec.fe_configs))) if spec.fe_configs else (None,)
    )
    return [
        Member(fold=f, seed=base_seed + s, lr=lr, reg=reg, cost_fp=cfp, cost_fn=cfn, fe=fe)
        for fe in fes
        for f in range(n_folds)
        for s in range(spec.seeds)
        for lr in lrs
        for reg in regs
        for cfp in cfps
        for cfn in cfns
    ]


def _fold_masks(members: Sequence[Member], folds, n: int) -> np.ndarray:
    """(P, n) float32 train-row masks of a multi-fold population."""
    masks = np.zeros((len(members), n), dtype=np.float32)
    for i, m in enumerate(members):
        masks[i, folds[m.fold][0]] = 1.0
    return masks


def _member_axes(members, base_cfg):
    """The linear family's per-member steps, regs, seeds and class
    weights (cost_fn weights the positive class, cost_fp the negative),
    shared by both engines so their member order cannot drift."""
    return (
        [m.lr if m.lr is not None else base_cfg.step_size for m in members],
        [m.reg if m.reg is not None else base_cfg.reg_param for m in members],
        [m.seed for m in members],
        [m.cost_fn if m.cost_fn is not None else base_cfg.weight_pos for m in members],
        [m.cost_fp if m.cost_fp is not None else base_cfg.weight_neg for m in members],
    )


def _null_stage(_name, **_attrs):
    return contextlib.nullcontext()


def _rows(features: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return features[torch.as_tensor(idx, dtype=torch.long, device=features.device)]


def _stacked_features(members, feature_sets, row_idx=None) -> torch.Tensor:
    """(P, n, d) float32 member-axis stack of an ``fe_sweep=`` population:
    member i's matrix is its config's, gathered to ``row_idx`` (the
    shared single-fold train rows) when given."""
    mats = []
    for m in members:
        f = feature_sets[m.fe][1].to(torch.float32)
        mats.append(f if row_idx is None else _rows(f, row_idx))
    return torch.stack(mats)


def member_mesh_axis(mesh):
    """The mesh axis (or axes) the member axis shards over: on a pod's
    hybrid mesh (its process axis, ``hosts``, outermost) every axis,
    hosts first, so the members span every device of every process;
    otherwise ``data`` when the mesh has it (the population is data
    parallelism over members), else its first axis. A string for one
    axis, a tuple for several."""
    from ..parallel import mesh as pmesh

    if mesh.process_axis is not None:
        return (mesh.process_axis,) + tuple(a for a in mesh.axis_names
                                            if a != mesh.process_axis)
    return pmesh.DATA_AXIS if pmesh.DATA_AXIS in mesh.axis_names else mesh.axis_names[0]


def run_population(
    name: str,
    make_classifier: Callable,
    config: Dict[str, str],
    features: torch.Tensor,
    targets,
    spec: PopulationSpec,
    stage: Optional[Callable] = None,
    states: Optional[Dict] = None,
    feature_sets: Optional[Sequence[Tuple[str, torch.Tensor]]] = None,
    mesh=None,
) -> Tuple[stats.PopulationStatistics, Dict]:
    """Train and test one classifier family's population on ``features``
    (n, d) rows on the run's device with ``targets`` (n,).

    Returns ``(PopulationStatistics, block)``, the block being the JAX
    package's population record (``classifier``, ``members``, ``mode``,
    ``requested_mode``, ``mesh``, ``shape``, ``compiles`` None: the port
    compiles no programs, ``accuracy``, ``summary``); ``mesh`` is None
    without a mesh, else the JAX package's record (``rung``, ``axis``,
    ``shape``, ``devices``, and for a sharded training
    ``members_per_device`` and ``padded_members``). ``stage`` is
    the builder's stage context (the ``train`` and ``test`` wall times);
    ``states``, when given, receives ``{label: {"state", "test_index",
    "predictions"}}`` per member (the trained weights or network, the
    member's test rows and its predictions on them).

    ``feature_sets`` carries the ``fe_sweep=`` axis: ``(config, (n, d)
    rows)`` pairs, one per ``spec.fe_configs`` entry, all over the same
    rows and of one shape; each member trains and tests on its config's
    matrix (the batched engine takes them stacked on the member axis).
    Linear family only.

    ``mesh``: a ``parallel.mesh.Mesh``; the linear family in ``vmap``
    mode trains with its members split over :func:`member_mesh_axis`
    (block ``mode`` "sharded")."""
    from .. import obs
    from ..obs import events
    from ..parallel.population import PopulationVmapUnsupported

    if name not in SGD_FAMILY:
        raise ValueError(
            f"population training supports the SGD family "
            f"({', '.join(SGD_FAMILY)}); {name!r} trains one model per run"
        )
    linear = name in ("logreg", "svm")
    if spec.fe_configs and not linear:
        raise ValueError(
            "fe_sweep= applies to the linear family (logreg/svm); the "
            f"{name} engine shares one feature matrix"
        )
    if spec.fe_configs:
        if feature_sets is None or len(feature_sets) != len(spec.fe_configs):
            raise ValueError(
                f"fe_sweep= lists {len(spec.fe_configs)} configs but "
                f"{0 if feature_sets is None else len(feature_sets)} "
                f"feature matrices were provided"
            )
        shapes = {tuple(f.shape) for _, f in feature_sets}
        if len(shapes) != 1:
            raise ValueError(
                f"fe_sweep= feature configs must agree on the feature "
                f"matrix shape to share one stacked program; got "
                f"{sorted(shapes)} — match the level=/stats= sets"
            )
    stage = stage or _null_stage
    targets = np.asarray(targets, dtype=np.float64)
    n = len(targets)
    folds = folds_for(spec, n)

    template = make_classifier()
    template.set_config(config)
    if linear:
        base_cfg = template._sgd_config()
        base_seed = base_cfg.seed
    else:
        base_cfg = None
        base_seed = int(template._require("config_seed"))
    members = expand_members(spec, len(folds), base_seed, supports_reg=linear, name=name,
                             supports_cost=linear)
    if linear and spec.seeds > 1 and base_cfg.mini_batch_fraction >= 1.0:
        # the seed keys only the mini-batch sampler: these members train
        # identical models; kept (the axis was asked for) but flagged
        logger.warning(
            "seeds=%d is inert for full-batch %s (zero init, "
            "mini_batch_fraction>=1): seed members will be identical; "
            "set config_mini_batch_fraction<1 for a live seed axis", spec.seeds, name,
        )
        obs.metrics.count("population.degenerate_seed_axis")

    mode_used = spec.mode
    mesh_block = None
    n_shards = 1
    if mesh is not None:
        axis = member_mesh_axis(mesh)
        for a in (axis,) if isinstance(axis, str) else axis:
            n_shards *= int(mesh.shape[a])
        # the pod's multi-axis member spec renders joined ("hosts,data")
        mesh_block = {"rung": "single_device",
                      "axis": axis if isinstance(axis, str) else ",".join(axis),
                      "shape": mesh.shape, "devices": int(mesh.devices.size)}
        if not linear:
            logger.warning("population mesh sharding applies to the linear family "
                           "(logreg/svm); %s trains single-device", name)
            obs.metrics.count("population.mesh_unsupported_family")
        elif spec.mode != "vmap":
            logger.warning("population_mode=looped trains single-device; the mesh "
                           "applies to the vmapped engine")
    with stage("train", classifier=name, population=len(members)), events.span(
            f"population.{name}", classifier=name, members=len(members), mode=spec.mode):
        trained = None
        if mesh is not None and linear and spec.mode == "vmap":
            from ..parallel import population as engines

            trained = _train_sharded(features, targets, folds, members, base_cfg, mesh,
                                     feature_sets)
            mode_used = "sharded"
            padded = engines.pad_members(len(members), n_shards)
            mesh_block.update(rung="mesh", members_per_device=padded // n_shards,
                              padded_members=padded - len(members))
            obs.metrics.count("population.sharded_members", len(members))
        elif spec.mode == "vmap":
            try:
                trained = _train_vmapped(name, template, features, targets, folds, members,
                                         base_cfg, feature_sets)
            except PopulationVmapUnsupported as e:
                logger.warning("population %s falls back to looped training: %s", name, e)
                obs.metrics.count("population.fallback_looped")
                mode_used = "looped"
        if trained is None:
            trained = _train_looped(name, make_classifier, config, features, targets, folds,
                                    members, base_cfg, template, feature_sets)
        if features.device.type == "cuda":
            torch.cuda.synchronize(features.device)
    obs.metrics.count("population.members", len(members))
    obs.metrics.count(f"population.{mode_used}")

    result = stats.PopulationStatistics(shape=spec.describe(), mode=mode_used)
    with stage("test", classifier=name, population=len(members)):
        for m, state in zip(members, trained):
            if linear:
                template.model = LinearModel(state)
                template.margin_threshold = 0.0
            else:
                template.net = state
            _, test_idx = folds[m.fold]
            # the member's fe_sweep config's matrix, else the shared one
            rows = features if m.fe is None else feature_sets[m.fe][1]
            with events.span("population.member", classifier=name, member=m.label,
                             fold=m.fold, seed=m.seed):
                result[m.label] = template.test_features(_rows(rows, test_idx),
                                                         targets[test_idx])
            if states is not None:
                states[m.label] = {"state": state, "test_index": test_idx,
                                   "predictions": template.last_predictions}

    block = {
        "classifier": name,
        "members": len(members),
        "mode": mode_used,
        "requested_mode": spec.mode,
        "mesh": mesh_block,
        "shape": spec.describe(),
        "compiles": None,
        "accuracy": {label: round(s.calc_accuracy(), 6) for label, s in result.items()},
        "summary": result.summary(),
    }
    return result, block


def _labels(targets: np.ndarray, idx, device) -> torch.Tensor:
    t = targets if idx is None else targets[idx]
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def _stacked(members, feature_sets) -> bool:
    return feature_sets is not None and any(m.fe is not None for m in members)


def _train_vmapped(name, template, features, targets, folds, members, base_cfg,
                   feature_sets=None) -> List:
    """All members at once (``parallel/population.py``); an ``fe_sweep=``
    population hands the engine its (P, n, d) feature stack."""
    from ..parallel import population as engines
    from ..parallel.population import PopulationVmapUnsupported

    dev = features.device
    if name in ("logreg", "svm"):
        steps, regs, seeds, wpos, wneg = _member_axes(members, base_cfg)
        stacked = _stacked(members, feature_sets)
        if len(folds) == 1:
            # single fold: the shared train rows, gathered once
            train_idx = folds[0][0]
            x = (_stacked_features(members, feature_sets, train_idx) if stacked
                 else _rows(features, train_idx))
            weights, _, _ = engines.train_linear_population(
                x, _labels(targets, train_idx, dev), base_cfg,
                steps, regs, seeds, masks=None, weight_pos=wpos, weight_neg=wneg,
            )
        else:
            x = _stacked_features(members, feature_sets) if stacked else features
            weights, _, _ = engines.train_linear_population(
                x, _labels(targets, None, dev), base_cfg, steps, regs, seeds,
                masks=_fold_masks(members, folds, len(targets)), weight_pos=wpos,
                weight_neg=wneg,
            )
        return list(weights)
    # the network's engine shares one fold's gathered rows
    if len(folds) > 1:
        raise PopulationVmapUnsupported(
            "multi-fold NN populations train looped (the vmapped NN "
            "engine shares one gathered train matrix)"
        )
    train_idx = folds[0][0]
    lrs = [m.lr if m.lr is not None else float(template._require("config_learning_rate"))
           for m in members]
    return template.population_fit(_rows(features, train_idx),
                                   _labels(targets, train_idx, dev),
                                   [m.seed for m in members], lrs)


def _train_sharded(features, targets, folds, members, base_cfg, mesh,
                   feature_sets=None) -> List:
    """The linear family's members over ``mesh``: the fold and feature
    dispatch of :func:`_train_vmapped`, handed to
    ``train_linear_population_sharded``."""
    from ..parallel import population as engines

    dev = features.device
    steps, regs, seeds, wpos, wneg = _member_axes(members, base_cfg)
    stacked = _stacked(members, feature_sets)
    if len(folds) == 1:
        train_idx = folds[0][0]
        x = (_stacked_features(members, feature_sets, train_idx) if stacked
             else _rows(features, train_idx))
        y, masks = _labels(targets, train_idx, dev), None
    else:
        x = _stacked_features(members, feature_sets) if stacked else features
        y, masks = _labels(targets, None, dev), _fold_masks(members, folds, len(targets))
    weights = engines.train_linear_population_sharded(
        x, y, base_cfg, steps, regs, seeds, masks, mesh, weight_pos=wpos, weight_neg=wneg,
        axis=member_mesh_axis(mesh),
    )
    return list(weights.to(dev))


def _train_looped(name, make_classifier, config, features, targets, folds, members,
                  base_cfg, template=None, feature_sets=None) -> List:
    """One member at a time: single-fold linear members are the
    ``train_clf=`` invocation (the gathered rows); multi-fold linear
    members train over the full matrix with their fold's mask, so their
    mini-batch draws span the same n rows as the batched engine's; an
    ``fe_sweep=`` member trains on its config's matrix of the stack the
    batched engine takes; nn members are ``fit`` with the member's seed
    and learning rate."""
    from . import sgd
    from ..parallel import population as engines

    dev = features.device
    linear = name in ("logreg", "svm")
    stacked = linear and _stacked(members, feature_sets)
    if linear and (len(folds) > 1 or stacked):
        steps, regs, seeds, wpos, wneg = _member_axes(members, base_cfg)
        if len(folds) > 1:
            masks = _fold_masks(members, folds, len(targets))
            x = _stacked_features(members, feature_sets) if stacked else features
            y = _labels(targets, None, dev)
        else:
            train_idx = folds[0][0]
            masks = None
            x = _stacked_features(members, feature_sets, train_idx)
            y = _labels(targets, train_idx, dev)
        weights = engines.train_linear_population_looped(
            x, y, base_cfg, steps, regs, seeds, masks, weight_pos=wpos, weight_neg=wneg,
        )
        return list(weights)
    trained = []
    for m in members:
        train_idx, _ = folds[m.fold]
        x, y = _rows(features, train_idx), _labels(targets, train_idx, dev)
        if linear:
            cfg = dataclasses.replace(
                base_cfg,
                step_size=m.lr if m.lr is not None else base_cfg.step_size,
                reg_param=m.reg if m.reg is not None else base_cfg.reg_param,
                seed=m.seed,
                weight_pos=m.cost_fn if m.cost_fn is not None else base_cfg.weight_pos,
                weight_neg=m.cost_fp if m.cost_fp is not None else base_cfg.weight_neg,
            )
            trained.append(sgd.train_linear(x, y, cfg))
        else:
            clf = make_classifier()
            member_config = dict(config)
            member_config["config_seed"] = str(m.seed)
            if m.lr is not None:
                member_config["config_learning_rate"] = repr(m.lr)
            clf.set_config(member_config)
            clf.fit(x, y)
            if template is not None and template._arch is None:
                template._arch = clf._arch
            trained.append(clf.net)
    return trained
