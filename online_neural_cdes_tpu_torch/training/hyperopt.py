"""Hyperparameter search over dunder-encoded parameter spaces.

PyTorch port's counterpart of the JAX package's ``training/hyperopt.py``,
with its search and its records: a budgeted search (default 20 trials)
over spaces like ``{"name": "model__hidden_dim", "type": "range",
"bounds": [32, 256]}`` with optional ``log_scale``; the objective is a
validation metric; a failed trial scores a sentinel and the search goes on;
``best_parameters`` are returned for the sweep to store in the ledger.

1. **Sobol startup** (scrambled, ``scipy.stats.qmc``): low-discrepancy
   exploration for the first ``startup_trials`` (default half the budget).
2. **TPE refinement** (tree-structured Parzen estimator): the observed
   trials split at the gamma-quantile of the score, factorised Parzen
   densities l(x) (good) and g(x) (bad) in the unit cube, candidates drawn
   from l, the maximiser of l(x)/g(x) kept.

Deterministic under the config seed; ``search: "sobol"`` or ``"random"``
skips the TPE stage.  Only numpy and scipy: the search runs on a machine
without scikit-learn or pandas.

**Waves**: ``wave_size: K`` proposes K candidates per wave (TPE
conditions on completed waves only) and trains same-shape candidates of a
wave as one K-lane program (``training/wave.py``).  ``wave_size: 1``
(default) is the sequential search.  Every trial is recorded in the
ledger under ``"<run_name>::trials"`` as it completes, and a search run
again replays its records.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import numpy as np

from online_neural_cdes_tpu_torch.training.experiment import run_experiment

__all__ = ["run_hyperopt", "sample_parameterization", "sobol_parameterizations",
           "tpe_suggest", "decode_dunder"]

logger = logging.getLogger(__name__)
FAILURE_SENTINEL = 1000.0


def _decode_unit(param: dict, u: float):
    """Map a unit-interval draw onto one Ax-style parameter."""
    if param["type"] == "choice":
        values = param["values"]
        return values[min(int(u * len(values)), len(values) - 1)]
    if param["type"] == "range":
        lo, hi = param["bounds"]
        if param.get("log_scale"):
            val = float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
        else:
            val = lo + u * (hi - lo)
        # Integer bounds mean an integer parameter regardless of scale
        # (the Ax contract this mirrors): a log-scaled hidden_dim range
        # must not decode to 77.3.
        if isinstance(lo, int) and isinstance(hi, int):
            return int(np.clip(round(val), lo, hi))
        return float(val)
    if param["type"] == "fixed":
        return param["value"]
    raise ValueError(f"Unknown parameter type {param['type']}")


def _split_space(space: List[dict]):
    dims = [p for p in space if p["type"] != "fixed"]
    fixed = [p for p in space if p["type"] == "fixed"]
    return dims, fixed


def _decode_row(dims, fixed, row) -> dict:
    point = {p["name"]: _decode_unit(p, float(u)) for p, u in zip(dims, row)}
    point.update({p["name"]: p["value"] for p in fixed})
    return point


def _sobol_unit(n_dims: int, n: int, seed: int) -> np.ndarray:
    from scipy.stats import qmc

    if n_dims == 0:
        return np.zeros((n, 0))
    return qmc.Sobol(d=n_dims, scramble=True, seed=seed).random(n)


def sobol_parameterizations(space: List[dict], n: int, seed: int = 0) -> List[dict]:
    """``n`` scrambled-Sobol points over an Ax-style space, deterministic
    under ``seed``.  Low-discrepancy: every 1-D projection of a 2^k-point
    draw lands exactly one point in each of the 2^k dyadic bins."""
    dims, fixed = _split_space(space)
    unit = _sobol_unit(len(dims), n, seed)
    return [_decode_row(dims, fixed, row) for row in unit]


def tpe_suggest(
    unit_obs: np.ndarray,
    scores: np.ndarray,
    rng: np.random.Generator,
    n_candidates: int = 64,
    gamma: float = 0.25,
) -> np.ndarray:
    """One TPE acquisition step in the unit cube (Bergstra et al. 2011):
    split observations at the gamma-quantile of the (lower-is-better)
    score, model good/bad with factorised Parzen mixtures, sample
    candidates from the good density and return the argmax of
    log l(x) - log g(x)."""
    from scipy.special import logsumexp

    n, d = unit_obs.shape
    if d == 0:
        return np.zeros(0)
    order = np.argsort(scores, kind="stable")
    n_good = max(1, int(np.ceil(gamma * n)))
    good = unit_obs[order[:n_good]]
    bad = unit_obs[order[n_good:]]
    bw = max(0.08, 1.0 / np.sqrt(max(len(good), 1)) * 0.5)

    base = good[rng.integers(len(good), size=n_candidates)]
    cands = np.clip(base + rng.normal(0.0, bw, size=base.shape), 0.0, 1.0)

    def log_density(data: np.ndarray, pts: np.ndarray) -> np.ndarray:
        if len(data) == 0:
            return np.zeros(len(pts))
        z = (pts[:, None, :] - data[None, :, :]) / bw     # (C, N, D)
        per_dim = logsumexp(-0.5 * z**2, axis=1) - np.log(len(data))
        return per_dim.sum(axis=1)

    acq = log_density(good, cands) - log_density(bad, cands)
    return cands[int(np.argmax(acq))]


def sample_parameterization(space: List[dict], rng: np.random.Generator) -> dict:
    """One uniform draw from an Ax-style space (kept for ad-hoc sampling;
    the search itself uses :func:`sobol_parameterizations`)."""
    return {p["name"]: _decode_unit(p, float(rng.uniform())) for p in space}


def decode_dunder(parameterization: dict) -> dict:
    """model__hidden_dim=64 -> {"model": {"hidden_dim": 64}}
    (reference hyperoptimize.py:103-126)."""
    out: dict = {}
    for key, value in parameterization.items():
        node = out
        parts = key.split("__")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def run_hyperopt(
    config: dict,
    data_root: str = "data/processed",
    mesh=None,
    ledger=None,
    run_name: Optional[str] = None,
    verbose: bool = False,
    device=None,
) -> dict:
    """Budgeted search on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for); returns the best trial's results plus ``best_parameters``
    (stored by the sweep into the ledger for later ``update_hyperparams``
    injection).  ``mesh=`` is ROADMAP item 18 and raises.

    With ``ledger`` given, every trial is recorded as it completes (under
    ``"<run_name>::trials"``) and a crashed search RESUMES from the
    recorded history instead of restarting from trial 0 — the re-entrant
    semantics the sweep layer promises apply within a search, not just
    across configs.  The TPE stage draws from a per-trial RNG seeded by
    (seed, trial), so a resumed search is bit-identical to an
    uninterrupted one."""
    if mesh is not None:
        raise NotImplementedError(
            "run_hyperopt(mesh=...) is not ported yet (ROADMAP item 18: parallel/ as "
            "torch.distributed data parallel)")
    space = config["parameterization"]
    total_trials = int(config.get("total_trials", 20))
    metric = config.get("evaluation_metric", "loss")
    minimize = bool(config.get("minimize", metric == "loss"))
    sign = 1.0 if minimize else -1.0
    seed = int(config.get("seed", 0))
    search = config.get("search", "tpe")
    # Wave-parallel evaluation: ``wave_size`` candidates are proposed per
    # wave (TPE conditions on completed waves only; wave_size=1 is the
    # sequential search, bit-identical to previous behaviour) and
    # same-shape candidates within a wave train as one vmapped program
    # (``wave_vmap=False`` forces sequential evaluation of the same wave
    # structure — the equivalence oracle the tests compare against).
    wave_size = max(1, int(config.get("wave_size", 1)))
    wave_vmap = bool(config.get("wave_vmap", True))
    dims, fixed = _split_space(space)
    # search modes: "tpe" (default, Sobol startup then TPE refinement),
    # "sobol" (pure low-discrepancy), "random" (iid uniform — the
    # head-to-head baseline; scripts/hyperopt_headtohead.py).
    n_startup = (
        total_trials if search in ("sobol", "random")
        else min(total_trials, max(5, int(config.get(
            "startup_trials", total_trials // 2))))
    )
    # Full-length Sobol table: trials whose wave begins before ANY scored
    # history exists (a wave spanning the whole startup phase) continue
    # the low-discrepancy sequence instead of calling TPE with nothing.
    startup_unit = (
        np.random.default_rng((seed, 7919)).uniform(
            size=(total_trials, len(dims)))
        if search == "random"
        else _sobol_unit(len(dims), total_trials, seed)
    )

    from online_neural_cdes_tpu_torch.training.ledger import config_hash

    trials_run_name = f"{run_name or 'hyperopt'}::trials"
    # wave_vmap changes HOW a wave is evaluated, not WHICH candidates run:
    # records from either mode are interchangeable, so it is excluded from
    # the search identity.
    search_key = config_hash(
        {k: v for k, v in config.items() if k != "wave_vmap"}
    )
    recorded: dict = {}
    if ledger is not None:
        for e in ledger.query(
            lambda e: e.get("run_name") == trials_run_name
            and e.get("status") == "completed"
            and e.get("config", {}).get("search") == search_key
        ):
            recorded[int(e["config"]["trial"])] = e

    def trial_config(point: dict) -> dict:
        trial_cfg = {k: v for k, v in config.items()
                     if k not in ("parameterization", "total_trials",
                                  "startup_trials", "search", "wave_size",
                                  "wave_vmap")}
        return _merge(trial_cfg, decode_dunder(point))

    def run_one(point: dict):
        try:
            results = run_experiment(trial_config(point), data_root=data_root,
                                     verbose=verbose, device=device)
            score = sign * results[f"val.{metric}"]
            if not np.isfinite(score):
                # Same sentinel contract as the wave: a NaN score must not
                # poison the TPE history or the best-trial compare.
                score = FAILURE_SENTINEL
        except Exception as exc:  # the search's contract: a failed trial
            # scores the sentinel and the search goes on; the traceback is
            # logged and the trial's results carry the error.
            logger.warning("hyperopt trial failed: %s", exc, exc_info=True)
            results = {"error": str(exc)}
            score = FAILURE_SENTINEL
        return score, results

    def run_wave(points: List[dict], on_result=None):
        """Evaluate one wave's candidates.  Groups whose members share a
        program signature (differ only in the waveable trainer scalars --
        lr, final_lr_multiplier, scheduler knobs) train as one wave
        (training/wave.py); the rest, and a group whose model cannot wave
        (WaveUnsupported), run one after another.  Results are order-aligned with ``points``.

        ``on_result(local_index, score, results)`` fires as soon as each
        candidate's evaluation completes (a vmapped group completes as one
        unit), so the caller can persist finished trials before the wave
        ends — a crash mid-wave then loses only the evaluation in flight,
        not the wave's earlier trials."""
        from online_neural_cdes_tpu_torch.training.wave import (
            WaveUnsupported, run_trials_vmapped, vmappable_groups,
        )

        out: list = [None] * len(points)
        for group in vmappable_groups(points):
            if wave_vmap and len(group) > 1:
                try:
                    group_results = run_trials_vmapped(
                        [trial_config(points[i]) for i in group],
                        data_root=data_root, verbose=verbose, device=device,
                    )
                    for i, results in zip(group, group_results):
                        s = sign * results[f"val.{metric}"]
                        out[i] = (
                            (FAILURE_SENTINEL, results)
                            if not np.isfinite(s) else (s, results)
                        )
                        if on_result is not None:
                            on_result(i, *out[i])
                    continue
                except WaveUnsupported as exc:
                    logger.warning("wave group rejected (%s); running its trials "
                                   "one after another", exc)
            for i in group:
                out[i] = run_one(points[i])
                if on_result is not None:
                    on_result(i, *out[i])
        return out

    unit_obs: list = []
    scores: list = []
    best = (math.inf, None, None)
    # Per-trial replay: a trial's candidate row is a DETERMINISTIC function
    # of the wave-start history (startup rows come from `seed`; TPE
    # candidates condition on COMPLETED waves only and draw from an rng
    # keyed (seed, t)), so each recorded entry can be validated
    # independently — regenerate the row the search would propose now and
    # replay the record iff its unit_row matches.  A mismatch means the
    # history the record was generated against has diverged (some earlier
    # trial was re-run with a different outcome); that record is stale and
    # is re-evaluated/overwritten (the ledger's last-entry-wins read
    # handles the overwrite).  This replays recorded wave members even
    # when an earlier member of the same wave is missing — a prefix-only
    # rule discarded those and paid a full training run each (ADVICE r3).
    trial = 0
    while trial < total_trials:
        wave = list(range(trial, min(trial + wave_size, total_trials)))
        hist_rows = np.asarray(unit_obs)
        hist_scores = np.asarray(scores)

        wave_rows, wave_points, pending = [], [], []
        wave_out: dict = {}
        for t in wave:
            if t < n_startup or hist_rows.size == 0:
                row = startup_unit[t]
            else:
                rng = np.random.default_rng((seed, t))
                row = tpe_suggest(hist_rows, hist_scores, rng)
            row = np.asarray(row, float)
            entry = recorded.get(t)
            rec_row = (
                np.asarray(entry["info"]["unit_row"], float)
                if entry is not None else None
            )
            if (
                rec_row is not None
                and rec_row.shape == row.shape
                and np.allclose(rec_row, row, rtol=0, atol=1e-12)
            ):
                row = rec_row
                wave_out[t] = (
                    float(entry["results"]["score"]),
                    entry["results"].get("trial_results", {}),
                )
                point = entry["info"]["point"]
                logger.info("trial %d/%d: resumed from ledger (score %.5f)",
                            t + 1, total_trials, wave_out[t][0])
            else:
                point = _decode_row(dims, fixed, row)
                pending.append(t)
            wave_rows.append(row)
            wave_points.append(point)

        if pending:
            def persist(local_i, score, results):
                # Fires the moment a trial's evaluation completes, so a
                # crash mid-wave loses only the in-flight evaluation —
                # the sequential wave_size=1 search's per-trial durability
                # contract holds inside waves too (the replay logic above
                # already regenerates any missing wave members from the
                # same wave-start history).
                t = pending[local_i]
                logger.info("trial %d/%d: %s -> score %.5f", t + 1,
                            total_trials, wave_points[t - trial], score)
                if ledger is not None:
                    # Full results (json-serialisable: history is a list of
                    # float dicts; only the array-valued best_params key is
                    # stripped) — a resumed search whose best trial is
                    # replayed must return the same results dict as an
                    # uninterrupted one.
                    ledger.save_result(
                        {"search": search_key, "trial": t},
                        {"score": float(score),
                         "trial_results": {k: v for k, v in results.items()
                                           if k != "best_params"}},
                        run_name=trials_run_name,
                        info={"unit_row": np.asarray(
                            wave_rows[t - trial], float).tolist(),
                            "point": wave_points[t - trial]},
                    )

            pend_results = run_wave(
                [wave_points[t - trial] for t in pending], on_result=persist
            )
            for t, (score, results) in zip(pending, pend_results):
                wave_out[t] = (score, results)

        for t in wave:
            score, results = wave_out[t]
            unit_obs.append(wave_rows[t - trial])
            scores.append(score)
            if score < best[0]:
                best = (score, wave_points[t - trial], results)
        trial = wave[-1] + 1

    score, point, results = best
    results = dict(results or {})
    results["best_parameters"] = decode_dunder(point) if point else {}
    results["best_score"] = score
    return results


def _merge(config: dict, update: dict) -> dict:
    import copy

    out = copy.deepcopy(config)
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out
