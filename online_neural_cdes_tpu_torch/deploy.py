"""Checkpoint -> serving-artifact exporter (command line and library).

PyTorch counterpart of the JAX package's ``deploy.py``.  Given an
experiment config (the dict ``training.experiment.run_experiment`` trains
from) and a ``best_params`` checkpoint written by
``train(checkpoint_dir=...)``, it rebuilds the model bundle through the
code path that trained it, attaches the serving-side coefficient build
for the config's interpolation key, and writes an artifact
(``serving_export``) that a server loads without the model code.

    python -m online_neural_cdes_tpu_torch.deploy \\
        --config runs/mimic.json5 --checkpoint runs/ckpt/best_params \\
        --out artifacts/mimic --max-length 200 --batch-buckets 1,8,64

The model and the export run on the card unless ``--device cpu`` is
given; ``--platforms`` (default ``cuda,cpu``) names the devices the
artifact may be loaded on.  Every solver but ``scipy_solver`` exports
(the adaptive and Adams ones as their tensor form).  A config on a
global-spline key (``hermite``, ``cubic``: a ``hermite-dopri5`` leg) serves
requests of the corpus length only, where no length pad touches the
build: its predictor takes ``exact_length`` (one length bucket, recorded
in the manifest), and the live and the loaded predictor refuse any other
request length.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

__all__ = [
    "serving_coeff_fn",
    "build_predictor_from_config",
    "build_stepper_from_config",
    "main",
]


_GLOBAL_SPLINE_KEYS = ("cubic", "hermite")


def serving_coeff_fn(interpolation: Optional[str]):
    """The raw-series -> model-inputs transform for a dataset
    interpolation key: what ``data/common.py::interpolate`` does to the
    stored corpus (first-row NaN zeroing and the key's coefficient
    builder), traced into the artifact so it runs on the device per
    request.  Requests must be in the corpus's input space: normalised
    values with the prepended time channel (``temporal_data_raw``'s).

    Keys whose coefficient build cannot reproduce the training-time
    forward under the predictor's length padding (``cubic``, ``hermite``)
    are refused with a recipe rather than served skewed;
    :func:`build_predictor_from_config` serves them at the corpus length
    alone (:func:`_global_spline_key`)."""
    from online_neural_cdes_tpu_torch.data.common import _coeff_fn
    from online_neural_cdes_tpu_torch.data.loader import (
        parse_interpolation_string, parse_logsig_string,
    )

    data_key, model_interp = parse_interpolation_string(interpolation)

    if model_interp is not None and model_interp.startswith("logsig"):
        from online_neural_cdes_tpu_torch.ops.interpolation import (
            linear_interpolation_coeffs,
        )
        from online_neural_cdes_tpu_torch.ops.logsig import logsig_windows

        depth, window = parse_logsig_string(model_interp)

        def logsig_fn(x):
            # The transform fills NaNs itself; pad rows are zero increments
            # (Chen's identity), so bucket padding cannot change a window.
            return linear_interpolation_coeffs(logsig_windows(x, depth, window))

        return logsig_fn

    if model_interp == "rectilinear-intensity":
        raise ValueError(
            "rectilinear-intensity serving needs the cumulative-measurement "
            "channels appended host-side (data/loader.py::"
            "add_rectilinear_intensity); precompute them in the client and "
            "export with interpolation='rectilinear' over the augmented "
            "channels instead.")

    if data_key in _GLOBAL_SPLINE_KEYS:
        # A forward-filled length pad is not inert for these builds: the
        # natural cubic's solve is global and the Hermite pad pieces carry
        # the last backward difference, so the state keeps moving across
        # the pad.  Linear and rectilinear pads have dX = 0 and are exact.
        raise ValueError(
            f"{data_key} serving under length padding deviates from the "
            "training-time coefficient build (global/derivative-carrying "
            "spline). Either serve requests of one length only: "
            "build_predictor_from_config and the deploy command do so at the "
            "corpus length (Predictor(exact_length=) with the builder from "
            f"data.common._coeff_fn({data_key!r})), or train with a pad-inert "
            "key (linear / rectilinear / logsig-*).")

    if data_key == "raw":
        raise ValueError(
            "the config has no dataset interpolation key (raw-space "
            "data); NCDE serving needs one of linear / rectilinear / "
            "linear_forward_fill / logsig-* -- or pass an explicit "
            "coeff_fn= for a custom request transform.")

    return _first_row_filled(_coeff_fn(data_key))


def _first_row_filled(builder):
    def coeff_fn(x):
        # interpolate()'s causal initial-NaN -> 0 fill.
        first = x[:, :1].masked_fill(torch.isnan(x[:, :1]), 0.0)
        return builder(torch.cat([first, x[:, 1:]], dim=1))

    return coeff_fn


def _global_spline_key(interpolation: Optional[str]) -> Optional[str]:
    """The data key (``cubic`` or ``hermite``) when the served build of
    ``interpolation`` is a global spline, which serves at one request
    length only; else None."""
    from online_neural_cdes_tpu_torch.data.loader import parse_interpolation_string

    data_key, model_interp = parse_interpolation_string(interpolation)
    if model_interp is not None and (model_interp.startswith("logsig")
                                     or model_interp == "rectilinear-intensity"):
        return None
    return data_key if data_key in _GLOBAL_SPLINE_KEYS else None


def _rebuild(config: dict, checkpoint: str, data_root: Optional[str], device=None):
    """config + checkpoint -> (bundle, splits, params, raw channels, longest
    series, val_eval) through the experiment module's own setup path, on
    ``device``.  ``val_eval`` is a zero-argument callable giving (val rows,
    val statics, val labels) for the reduced-precision task-metric gate."""
    from online_neural_cdes_tpu_torch.training.experiment import (
        DEFAULT_DATA_ROOT, load_and_setup, npz_path_for,
    )
    from online_neural_cdes_tpu_torch.utils.checkpoint import load_checkpoint

    data_root = data_root or DEFAULT_DATA_ROOT
    bundle, splits = load_and_setup(config, data_root, device=device)
    params = load_checkpoint(checkpoint, bundle.model.state_dict())

    ds = dict(config.get("dataset", {}))
    npz = np.load(npz_path_for(ds["data_loc"], data_root,
                               bool(config.get("test_mode", False))), allow_pickle=True)
    raw = npz["temporal_data_raw"]
    channels = int(np.asarray(raw[0]).shape[-1])
    max_length = int(max(len(np.asarray(r)) for r in raw))

    def val_eval():
        # The val split's raw rows and labels: the artifact is scored on the
        # config's own validation data (only reduced-precision --verify
        # exports pay for the copy).
        val_idxs = np.asarray(npz["val_idxs"])
        val_rows = [np.asarray(raw[i], np.float32) for i in val_idxs]
        val_static = (npz["static_data"].astype(np.float32)[val_idxs]
                      if "static_data" in npz.files and ds.get("use_static", True)
                      else None)
        return val_rows, val_static, np.asarray(npz["labels"])[val_idxs]

    return bundle, splits, params, channels, max_length, val_eval


def build_predictor_from_config(
    config: dict,
    checkpoint: str,
    data_root: Optional[str] = None,
    _rebuilt=None,
    *,
    device=None,
    **serving_kw,
):
    """Rebuild the trained model from ``config`` + ``checkpoint`` (on
    ``device``: the card unless ``"cpu"``) and wrap it as a raw-request
    :class:`~online_neural_cdes_tpu_torch.serving.Predictor`.  A
    global-spline key (``hermite``, ``cubic``) serves with
    ``exact_length`` the longest corpus series: requests of that length
    only, in one length bucket.

    Returns ``(predictor, info)``; ``info`` carries the export defaults
    derived from the corpus: raw ``channels``, ``max_length`` (the longest
    series), ``static_dim`` and ``model_string``."""
    from online_neural_cdes_tpu_torch.data.common import _coeff_fn
    from online_neural_cdes_tpu_torch.serving import predictor_from_bundle

    bundle, splits, params, channels, max_length, _ = (
        _rebuilt or _rebuild(config, checkpoint, data_root, device))
    ds = dict(config.get("dataset", {}))
    if bundle.model_string in ("ncde", "ncde-stacked", "ncde-attention"):
        # NCDE bundles train on precomputed coefficients; serving takes raw
        # rows, so the coefficient build moves into the predictor.
        spline_key = _global_spline_key(ds.get("interpolation"))
        if "coeff_fn" not in serving_kw and spline_key is not None:
            # A length pad would change this build (serving_coeff_fn): the
            # predictor serves the corpus length alone.
            serving_kw["coeff_fn"] = _first_row_filled(_coeff_fn(spline_key))
            serving_kw["exact_length"] = max_length
        elif "coeff_fn" not in serving_kw:
            serving_kw["coeff_fn"] = serving_coeff_fn(ds.get("interpolation"))
        model = bundle.model
        serving_kw.setdefault(
            "rectilinear_rows",
            bool(getattr(model, "return_sequences", False))
            and getattr(model, "interpolation", None) == "rectilinear"
            and not getattr(model, "return_filtered_rectilinear", True))
    elif "coeff_fn" not in serving_kw and ds.get("interpolation") is not None:
        # A recurrent bundle trained on interpolated rows would serve raw
        # rows through prepare_batch: other masks/deltas than it learned.
        raise ValueError(
            f"{bundle.model_string!r} was trained on interpolation="
            f"{ds.get('interpolation')!r} rows, but serving feeds raw "
            "request rows to its preparation -- the masks/deltas would "
            "differ from training. Use an interpolation: null config (the "
            "baselines' own contract) or pass an explicit coeff_fn=.")
    predictor = predictor_from_bundle(bundle, params, **serving_kw)
    info = {
        "channels": channels,
        "max_length": max_length,
        "static_dim": splits[0].static_dim if predictor.accept_static else None,
        "model_string": bundle.model_string,
    }
    return predictor, info


def build_stepper_from_config(
    config: dict,
    checkpoint: str,
    data_root: Optional[str] = None,
    _rebuilt=None,
    *,
    device=None,
):
    """Rebuild the trained model as a streaming
    :class:`~online_neural_cdes_tpu_torch.serving.OnlineNCDEStepper` (the
    plain rectilinear NCDE with a fixed-grid solver; the stepper's own
    guards refuse anything else).  Returns ``(stepper, info)``."""
    from online_neural_cdes_tpu_torch.serving import OnlineNCDEStepper

    bundle, splits, params, channels, _, _ = (
        _rebuilt or _rebuild(config, checkpoint, data_root, device))
    if bundle.model_string != "ncde":
        raise ValueError(
            "streaming export supports the plain NCDE only (got "
            f"{bundle.model_string!r}); stacked/attention/recurrent models "
            "have no incremental-exact step.")
    static_dim = splits[0].static_dim
    # A placeholder static binds the stepper's static head for export; the
    # serving process passes real per-stream statics to load_stepper.
    static = None if static_dim is None else np.zeros((1, static_dim), np.float32)
    stepper = OnlineNCDEStepper(bundle.model, static=static, device=bundle.device)
    stepper.params = params
    return stepper, {"channels": channels, "static_dim": static_dim}


def _verify_against_live(predictor, out_dir, channels, max_len, static_dim,
                         reduced_dtype):
    """Load-and-compare gate: synthetic rows (time channel first, the
    corpus input space; every one the predictor's ``exact_length`` long
    where it has one) through the loaded artifact against the live predictor, on
    its device.  Reduced-precision artifacts compare within tolerance,
    float32 to the bit.  Returns the 'verified' summary."""
    from online_neural_cdes_tpu_torch.serving_export import load_predictor

    rng = np.random.default_rng(0)
    lengths = ([predictor.exact_length] * 3 if predictor.exact_length is not None
               else sorted({min(4, max_len), max(1, max_len // 2), max_len}))
    rows = []
    for L in lengths:
        r = rng.normal(size=(L, channels)).astype(np.float32)
        r[:, 0] = np.arange(L)
        rows.append(r)
    static = (rng.normal(size=(len(rows), static_dim)).astype(np.float32)
              if static_dim else None)
    live_outs = predictor.predict(rows, static=static)
    art_outs = load_predictor(out_dir, device=predictor.device).predict(rows, static=static)
    for a, b in zip(art_outs, live_outs):
        if reduced_dtype is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)
    return "bit-exact" if reduced_dtype is None else f"within {reduced_dtype} tolerance"


def _stack_row_outputs(outs, target_len=None):
    """Per-request outputs -> one (N, ...) array; sequence outputs NaN-pad
    to ``target_len`` (the stored label length, so prediction and label
    positions align under the metrics' NaN mask)."""
    outs = [np.asarray(o) for o in outs]
    if target_len is None and all(o.shape == outs[0].shape for o in outs):
        return np.stack(outs)
    max_len = max([o.shape[0] for o in outs] + [target_len or 0])
    padded = np.full((len(outs), max_len) + outs[0].shape[1:], np.nan, np.float64)
    for i, o in enumerate(outs):
        padded[i, : o.shape[0]] = o
    return padded


def _dense_labels(labels) -> np.ndarray:
    """Stored labels -> one NaN-padded float64 array (ragged (L_i, ...)
    rows of an object array densified as the outputs are)."""
    labels = np.asarray(labels)
    if labels.dtype == object:
        return _stack_row_outputs([np.asarray(r, np.float64) for r in labels])
    return np.asarray(labels, np.float64)


def _gate_metrics(config, labels):
    """The task metrics that score a reduced-precision artifact: the
    config's trainer metrics; else those of its explicit loss; else
    inferred from the label space."""
    trainer_cfg = config.get("trainer", {}) or {}
    names = [m for m in trainer_cfg.get("metrics", []) if m != "loss"]
    if names:
        return names
    loss = trainer_cfg.get("loss_str")
    if loss in ("mse", "rmse"):
        return ["rmse"]
    if loss == "ce":
        return ["acc"]
    if loss == "bce":
        return ["auc", "acc"]
    dense = _dense_labels(labels)
    finite = dense[np.isfinite(dense)]
    if finite.size and np.allclose(finite, np.round(finite)):
        return ["auc", "acc"] if len(np.unique(finite)) <= 2 else ["acc"]
    return ["rmse"]


def _rmse_like(sqrt):
    def fn(preds, labs):
        preds = np.asarray(preds, np.float64)
        labs = np.asarray(labs, np.float64)
        # Align trailing singleton axes on either side, then NaN-mask.
        while preds.ndim > labs.ndim and preds.shape[-1] == 1:
            preds = preds[..., 0]
        while labs.ndim > preds.ndim and labs.shape[-1] == 1:
            labs = labs[..., 0]
        preds, labs = preds.reshape(-1), labs.reshape(-1)
        if preds.shape != labs.shape:
            raise ValueError(f"gate metric: {preds.shape} predictions vs {labs.shape} "
                             "labels after squeezing")
        mask = np.isfinite(labs)
        m = np.mean((preds[mask] - labs[mask]) ** 2)
        return float(np.sqrt(m) if sqrt else m)
    return fn


def _task_metric_gate(predictor, out_dir, val_eval, config, tol):
    """Task-metric gate for reduced-precision artifacts: the loaded
    artifact and the live float32 predictor scored on the config's val
    split with the config's metrics; refused when any metric departs the
    live value by more than ``tol``.  Returns the per-metric summary."""
    from online_neural_cdes_tpu_torch.serving_export import load_predictor
    from online_neural_cdes_tpu_torch.training.metrics import METRICS

    rows, static, raw_labels = val_eval() if callable(val_eval) else val_eval
    if static is not None and not getattr(predictor, "accept_static", True):
        # The corpus stores statics this model does not consume.
        static = None
    labels = _dense_labels(raw_labels)
    # Sequence labels carry a time axis the outputs pad to; one-shot
    # labels ((N,) or (N, 1)) do not.
    is_sequence = labels.ndim >= 2 and labels.shape[1] > 1
    target_len = labels.shape[1] if is_sequence else None
    live = _stack_row_outputs(predictor.predict(rows, static=static), target_len)
    art = _stack_row_outputs(load_predictor(out_dir, device=predictor.device).predict(
        rows, static=static), target_len)
    if is_sequence and live.ndim >= 2 and live.shape[1] > labels.shape[1]:
        # Requests longer than their stored label rows: NaN-pad the labels.
        pad_shape = (labels.shape[0], live.shape[1] - labels.shape[1])
        labels = np.concatenate([labels, np.full(pad_shape + labels.shape[2:], np.nan)],
                                axis=1)

    extra = {"rmse": _rmse_like(sqrt=True), "mse": _rmse_like(sqrt=False)}
    summary = {"tol": tol, "metrics": {}}
    failures = []
    names = _gate_metrics(config, labels)
    unknown = [n for n in names if n not in METRICS and n not in extra]
    if unknown:
        # A skipped metric would pass the gate vacuously.
        raise ValueError(
            f"task-metric gate: unknown metric(s) {unknown} in the config's "
            f"trainer.metrics; known: {sorted(METRICS) + sorted(extra)}")

    def guarded(fn, preds):
        # A metric undefined on the split (one class for AUC) is NaN.
        try:
            return float(fn(preds, labels))
        except ValueError:
            return float("nan")

    scored = 0
    for name in names:
        fn = METRICS.get(name) or extra[name]
        m_live, m_art = guarded(fn, live), guarded(fn, art)
        if not np.isfinite(m_live) and not np.isfinite(m_art):
            # Undefined for live and artifact alike: nothing to gate on.
            summary["metrics"][name] = {"skipped": "undefined on val split"}
            continue
        scored += 1
        delta = abs(m_art - m_live)
        summary["metrics"][name] = {"live_f32": round(m_live, 6),
                                    "artifact": round(m_art, 6),
                                    "abs_delta": round(delta, 6)}
        if not np.isfinite(delta) or delta > tol:
            failures.append(f"{name}: |{m_art:.6f} - {m_live:.6f}| = {delta:.6f} > tol {tol}")
    if scored == 0:
        raise ValueError(
            f"task-metric gate: every gate metric ({', '.join(names)}) is undefined on "
            "the config's val split -- the gate would be vacuous; export f32 or provide "
            "a val split the config's metrics can score")
    if failures:
        raise ValueError(
            "reduced-precision artifact fails the task-metric gate on the config's "
            f"val split: {'; '.join(failures)} -- raise --metric-tol only with cause, "
            "or export f32")
    return summary


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True,
                    help="experiment config: a json/json5 file holding the "
                         "run_experiment dict")
    ap.add_argument("--checkpoint", required=True,
                    help="best_params checkpoint from train(checkpoint_dir=)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--batch-buckets", default="1,8,64",
                    help="comma-separated request-batch buckets")
    ap.add_argument("--length-multiple", type=int, default=16)
    ap.add_argument("--max-length", type=int, default=None,
                    help="longest request to cover (default: corpus max; a "
                         "hermite or cubic config serves the corpus max alone)")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="devices the artifact may be loaded on")
    ap.add_argument("--device", default=None,
                    help="where the model is rebuilt and traced (the CUDA card "
                         "unless 'cpu')")
    ap.add_argument("--stepper", action="store_true",
                    help="also export a streaming-stepper artifact to "
                         "<out>/stepper (plain rectilinear NCDE configs)")
    ap.add_argument("--stream-batch-sizes", default="64",
                    help="comma-separated stream-batch sizes for --stepper")
    ap.add_argument("--stream-block-sizes", default="",
                    help="comma-separated catch-up block lengths K for "
                         "--stepper: each exports a step_block module "
                         "advancing K observations in one call "
                         "(load_stepper().step_many chunks a backlog "
                         "into them)")
    ap.add_argument("--params-dtype", default=None,
                    help="store parameters in this floating dtype (e.g. "
                         "bfloat16 -- halves the weight payload and serves "
                         "through the kernels' bf16 storage; outputs match f32 "
                         "to reduced-precision tolerance)")
    ap.add_argument("--verify", action="store_true",
                    help="after exporting, load the artifact in-process "
                         "and assert it serves synthetic rows identically "
                         "to the live predictor (adds 'verified' to the "
                         "summary); reduced-precision exports additionally "
                         "pass the task-metric gate on the config's val "
                         "split (see --metric-tol)")
    ap.add_argument("--metric-tol", type=float, default=0.01,
                    help="task-metric gate for reduced-precision artifacts "
                         "under --verify: max allowed |metric(artifact) - "
                         "metric(live f32)| on the config's val split for "
                         "each of the config's metrics (default 0.01)")
    ap.add_argument("--update-params-only", action="store_true",
                    help="roll the checkpoint into the EXISTING artifact "
                         "at --out (atomic params.npz rewrite; architecture "
                         "validated against the manifest) instead of "
                         "re-exporting")
    args = ap.parse_args(argv)

    from online_neural_cdes_tpu_torch.serving_export import (
        export_predictor, export_stepper, update_params,
    )
    from online_neural_cdes_tpu_torch.training.config import load_json

    config = load_json(args.config)
    rebuilt = _rebuild(config, args.checkpoint, args.data_root, args.device)

    if args.update_params_only:
        params = rebuilt[2]
        n = update_params(args.out, params)
        stepper_dir = os.path.join(args.out, "stepper")
        summary = {"artifact": args.out, "leaves_updated": n}
        if os.path.isdir(stepper_dir):
            summary["stepper_leaves_updated"] = update_params(stepper_dir, params)
        if args.verify:
            # Gate the rolled checkpoint too: a live predictor on the
            # artifact's own bucket grid.
            with open(os.path.join(args.out, "manifest.json")) as fh:
                manifest = json.load(fh)
            predictor, _ = build_predictor_from_config(
                config, args.checkpoint, _rebuilt=rebuilt,
                batch_buckets=tuple(manifest["batch_buckets"]),
                length_multiple=manifest["length_multiple"])
            reduced = next((d for d in manifest["leaf_dtypes"] if d != "float32"), None)
            summary["verified"] = _verify_against_live(
                predictor, args.out, manifest["channels"], manifest["max_length"],
                manifest["static_dim"], reduced)
            if reduced is not None:
                summary["metric_gate"] = _task_metric_gate(
                    predictor, args.out, rebuilt[5], config, args.metric_tol)
        print(json.dumps(summary))
        return args.out
    predictor, info = build_predictor_from_config(
        config, args.checkpoint, _rebuilt=rebuilt,
        batch_buckets=tuple(int(b) for b in args.batch_buckets.split(",")),
        length_multiple=args.length_multiple)
    max_length = args.max_length or info["max_length"]
    if predictor.exact_length is not None and max_length != predictor.exact_length:
        raise ValueError(
            f"--max-length {max_length}: this config's coefficient build serves "
            f"requests of the corpus length {predictor.exact_length} only")
    platforms = tuple(args.platforms.split(","))
    n = export_predictor(predictor, args.out, channels=info["channels"],
                         max_length=max_length, static_dim=info["static_dim"],
                         platforms=platforms, params_dtype=args.params_dtype)
    summary = {"artifact": args.out, "model": info["model_string"], "shapes_exported": n,
               "channels": info["channels"], "max_length": max_length}
    if args.verify:
        summary["verified"] = _verify_against_live(
            predictor, args.out, info["channels"], max_length, info["static_dim"],
            args.params_dtype)
        if args.params_dtype is not None:
            summary["metric_gate"] = _task_metric_gate(
                predictor, args.out, rebuilt[5], config, args.metric_tol)
    if args.stepper:
        stepper, sinfo = build_stepper_from_config(config, args.checkpoint,
                                                   _rebuilt=rebuilt)
        stepper_out = os.path.join(args.out, "stepper")
        summary["stepper_modules"] = export_stepper(
            stepper, stepper_out,
            batch_sizes=tuple(int(b) for b in args.stream_batch_sizes.split(",")),
            channels=sinfo["channels"], platforms=platforms,
            params_dtype=args.params_dtype,
            block_sizes=tuple(int(k) for k in args.stream_block_sizes.split(",") if k))
        summary["stepper_artifact"] = stepper_out
    print(json.dumps(summary))
    return args.out


if __name__ == "__main__":
    main()
