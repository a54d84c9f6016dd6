"""MIMIC-IV task preparation: Mortality, LOS, Ventilation, Sepsis.

Numpy counterpart of the JAX package's ``data/mimic.py``, with its
semantics:

1. **Mortality** — first 72h of the stay, one-shot label.
2. **LOS**       — stays < 72h, predict length-of-stay from <= 24h of data
                   with a minimum of 4 observations.
3. **Ventilation** — online: vented patients with 24h < stay < 72h; the
                   label at t is the ventilation state ~12h ahead; tail
                   beyond max_time-12 censored.
4. **Sepsis**    — online: positives before t=4h excluded; labels 1 inside
                   [first_pos-12, first_pos+6]; data censored after
                   first_pos+6.

It reads the ``reduced_format.npz`` contract (static_data, temporal_data,
{mortality,los,ventilation,sepsis}_data) and writes each task's processed
npz through ``data.common``; ``synthesize_reduced_format`` writes a
synthetic corpus with the same schema.  Everything here runs on the host,
once per corpus.
"""

from __future__ import annotations

import os
import numpy as np

from online_neural_cdes_tpu_torch.data.common import process_all_interpolations, save_processed

__all__ = ["perform_exclusions", "prepare_task", "prepare_all", "synthesize_reduced_format"]

VENT_ACTIVE_CODES = (1, 2, 3, 5)  # ventilation category codes counted as "on vent"


def _keep(data, idxs):
    if isinstance(data, list):
        return [data[i] for i in idxs]
    return data[idxs]


def _exclude_times(static, temporal, labels, max_time=72.0, method="drop"):
    """Drop patients exceeding ``max_time`` hours (or truncate with
    method='reduce'); reference prepare.py:40-72."""
    assert method in ("drop", "reduce")
    if method == "reduce":
        for i in range(len(temporal)):
            mask = temporal[i][:, 0] <= max_time
            temporal[i] = temporal[i][mask]
            if labels is not None:
                labels[i] = labels[i][mask]
        return static, temporal, labels
    keep = [i for i in range(len(temporal)) if temporal[i][:, 0].max() <= max_time]
    return _keep(static, keep), _keep(temporal, keep), _keep(labels, keep)


def _los_exclusions(static, temporal, labels):
    """24h < discharge < 72h; keep the first 24h with >= 4 observations
    (reference prepare.py:75-101 — note its loop keeps patients whose
    max_time <= 24 after the 72h cut; we mirror that behaviour)."""
    keep = []
    for i in range(len(temporal)):
        times = temporal[i][:, 0]
        if times.max() > 24.0:
            continue
        reduced = temporal[i][times <= 24.0]
        if len(reduced) > 4:
            temporal[i] = reduced
            keep.append(i)
    return _keep(static, keep), _keep(temporal, keep), _keep(labels, keep)


def _vent_exclusions(static, temporal, labels, horizon=12.0):
    """Vented patients with 24 < stay < 72; label at t becomes the vent
    state closest to t+12h; tail past max_time-12 censored; >= 4 points
    (reference prepare.py:104-144)."""
    keep = []
    for i in range(len(labels)):
        times, ls = labels[i][:, 0].copy(), labels[i][:, 1].copy()
        max_time = times.max()
        if not (ls.max() > 0 and 24.0 < max_time < 72.0):
            continue
        on_vent = np.isin(ls, VENT_ACTIVE_CODES).astype(ls.dtype)
        new_labels = on_vent.copy()
        cut = max_time - horizon
        for j, time in enumerate(times):
            if time >= cut:
                break
            query_idx = int(np.argmin(np.abs(times - (time + horizon))))
            new_labels[j] = on_vent[query_idx]
        mask = times <= cut
        temporal[i] = temporal[i][mask]
        labels[i] = new_labels[mask]
        if len(labels[i]) >= 4:
            keep.append(i)
    return _keep(static, keep), _keep(temporal, keep), _keep(labels, keep)


def _process_continuous_labels(static, temporal, labels, exclude_before=4.0,
                               lookback=12.0, lookforward=6.0):
    """Sepsis windowing (reference prepare.py:147-191)."""
    keep = []
    for i, label in enumerate(labels):
        times, ls = label[:, 0].copy(), label[:, 1].copy()
        if ls.max() > 0:
            first_time = times[ls == 1].min()
            if first_time < exclude_before:
                continue
            ones = (times >= first_time - lookback) & (times <= first_time + lookforward)
            ls[ones] = 1
            mask = times <= first_time + lookforward
            if mask.sum() < 4:
                continue
            labels[i] = ls[mask]
            temporal[i] = temporal[i][mask]
        else:
            labels[i] = ls
        keep.append(i)
    return _keep(static, keep), _keep(temporal, keep), _keep(labels, keep)


def perform_exclusions(name: str, static, temporal, labels):
    """Task dispatch (reference prepare.py:194-227)."""
    static, temporal, labels = _exclude_times(static, temporal, labels,
                                              max_time=72.0, method="drop")
    if name == "LOS":
        static, temporal, labels = _los_exclusions(static, temporal, labels)
    elif name == "Sepsis":
        static, temporal, labels = _process_continuous_labels(static, temporal, labels)
    elif name == "Ventilation":
        static, temporal, labels = _vent_exclusions(static, temporal, labels)

    if name in ("LOS", "Mortality"):
        labels = np.asarray(labels, dtype=np.float32).reshape(-1, 1)
    else:
        assert all(len(t) == len(l) for t, l in zip(temporal, labels))
        labels = [np.asarray(l, np.float32).reshape(-1, 1) for l in labels]
    return static, temporal, labels


def prepare_task(name: str, reduced_npz_path: str, out_root: str,
                 test_mode: bool = False, num_test_samples: int = 100) -> str:
    """reduced_format.npz -> <out_root>/MIMIC-IV/<task>/... npz
    (reference prepare.py:230-270)."""
    npz = np.load(reduced_npz_path, allow_pickle=True)
    static = np.asarray(npz["static_data"], dtype=np.float32)
    temporal = [np.asarray(t, np.float32) for t in npz["temporal_data"]]
    label_key = {
        "Mortality": "mortality_data", "LOS": "los_data",
        "Ventilation": "ventilation_data", "Sepsis": "sepsis_data",
    }[name]
    raw_labels = npz[label_key]
    if raw_labels.dtype == object:
        labels = [np.asarray(l, np.float32) for l in raw_labels]
    else:
        labels = np.asarray(raw_labels, np.float32)

    if test_mode:
        static = static[:num_test_samples]
        temporal = temporal[:num_test_samples]
        labels = labels[:num_test_samples]

    static, temporal, labels = perform_exclusions(name, static, list(temporal), labels)
    processed = process_all_interpolations(static, temporal, None)
    return save_processed(processed, np.array(labels, dtype=object)
                          if isinstance(labels, list) else labels,
                          os.path.join(out_root, "MIMIC-IV", name),
                          test_mode=test_mode)


def prepare_all(reduced_npz_path: str, out_root: str = "data/processed",
                test_mode: bool = False):
    return {
        name: prepare_task(name, reduced_npz_path, out_root, test_mode)
        for name in ("Sepsis", "Mortality", "LOS", "Ventilation")
    }


def synthesize_reduced_format(path: str, num_patients: int = 64,
                              n_features: int = 5, seed: int = 0) -> str:
    """A synthetic reduced_format.npz with the real schema: ragged hourly
    series (time channel 0), statics, one-shot and online label tables."""
    rng = np.random.default_rng(seed)
    static, temporal = [], []
    mortality, los, vent, sepsis = [], [], [], []
    for _ in range(num_patients):
        length = int(rng.integers(6, 90))
        times = np.sort(rng.uniform(0.0, min(length, 100.0), length)).astype(np.float32)
        feats = rng.normal(size=(length, n_features)).astype(np.float32)
        feats[rng.uniform(size=feats.shape) < 0.4] = np.nan
        temporal.append(np.concatenate([times[:, None], feats], axis=1))
        static.append(rng.normal(size=7).astype(np.float32))
        mortality.append(float(rng.integers(0, 2)))
        los.append(float(times.max()))
        vent_state = (rng.uniform(size=length) < 0.2) * rng.choice([1, 2, 3, 5], size=length)
        vent.append(np.stack([times, vent_state.astype(np.float32)], axis=1))
        sep = np.zeros(length, np.float32)
        if rng.uniform() < 0.5:
            start = int(rng.integers(1, length))
            sep[start:] = 1.0
        sepsis.append(np.stack([times, sep], axis=1))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        static_data=np.stack(static),
        temporal_data=np.array(temporal, dtype=object),
        mortality_data=np.asarray(mortality, np.float32),
        los_data=np.asarray(los, np.float32),
        ventilation_data=np.array(vent, dtype=object),
        sepsis_data=np.array(sepsis, dtype=object),
    )
    return path
