"""Dataset builders: write the processed ``improved-neural-cdes_data.npz``
of a dataset.

PyTorch port's counterpart of the JAX package's ``data/builders.py``.
``build_toy_bm`` is the self-contained synthetic dataset of the smoke
suites and tests.  The raw-archive builders read files already on disk
(UEA ``.ts`` files, the TSER archive's Beijing files, SpeechCommands wav
files) and raise ``FileNotFoundError`` when they are missing; none
downloads anything (``data/download.py`` holds the helpers).  Each writes
the npz the JAX builder writes from the same files.

    python -m online_neural_cdes_tpu_torch.data.builders toy --root data/processed
    python -m online_neural_cdes_tpu_torch.data.builders character_trajectories \
        --root data/processed --raw-dir data/raw/UEA
    python -m online_neural_cdes_tpu_torch.data.builders BeijingPM10 --raw-dir data/raw/TSR
    python -m online_neural_cdes_tpu_torch.data.builders speech_commands \
        --raw-dir data/raw/SpeechCommands [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from online_neural_cdes_tpu_torch.data.common import (
    add_time,
    process_all_interpolations,
    save_processed,
)
from online_neural_cdes_tpu_torch.data.ts_format import load_ts_file

__all__ = ["build_toy_bm", "build_character_trajectories", "build_tsr",
           "build_speech_commands", "BUILDERS"]


def build_toy_bm(root: str = "data/processed", num_paths: int = 512,
                 n_points: int = 10, seed: int = 0, test_mode: bool = False):
    """Synthetic Brownian-motion online task (sign of the running path),
    shaped like a real processed dataset: statics, NaN dropout, online
    labels that end early (NaN tail).  Writes the full npz and its
    test-mode variant (the first 100 samples); returns the full one's
    path."""
    rng = np.random.default_rng(seed)
    inc = rng.normal(size=(num_paths, n_points - 1)) / np.sqrt(n_points - 1)
    bm = np.concatenate([np.zeros((num_paths, 1)), np.cumsum(inc, 1)], 1)
    values = np.stack([bm, bm + 0.1 * rng.normal(size=bm.shape)], -1)
    # Missingness on channel 1.
    drop = rng.uniform(size=values[..., 1].shape) < 0.3
    values[..., 1][drop] = np.nan
    temporal = add_time(values).astype(np.float32)  # (N, L, 3), time channel 0

    labels = (bm > 0).astype(np.float32)
    # Online labels stop at a random end-time per path.
    ends = rng.integers(n_points // 2, n_points + 1, size=num_paths)
    for i, e in enumerate(ends):
        labels[i, e:] = np.nan

    static = rng.normal(size=(num_paths, 4)).astype(np.float32)
    strat = (bm[:, -1] > 0).astype(np.int64)

    processed = process_all_interpolations(static, temporal, strat)
    directory = os.path.join(root, "Toy/BM")
    path = save_processed(processed, labels, directory, test_mode=False)
    n_small = min(100, num_paths)
    small = process_all_interpolations(
        static[:n_small], temporal[:n_small], strat[:n_small]
    )
    save_processed(small, labels[:n_small], directory, test_mode=True)
    return path


def build_character_trajectories(root: str = "data/processed",
                                 raw_dir: str = "data/raw/UEA"):
    """UEA CharacterTrajectories from its TRAIN and TEST ``.ts`` files (3
    dimensions, 20 classes, ragged lengths), labels shifted to 0-based
    class ids."""
    ts_train = os.path.join(raw_dir, "CharacterTrajectories_TRAIN.ts")
    ts_test = os.path.join(raw_dir, "CharacterTrajectories_TEST.ts")
    if not (os.path.exists(ts_train) and os.path.exists(ts_test)):
        raise FileNotFoundError(
            "CharacterTrajectories .ts files not found under "
            f"{raw_dir}; download from timeseriesclassification.com (no "
            "network egress in this environment)."
        )
    series, labels = [], []
    for path in (ts_train, ts_test):
        s, l = load_ts_file(path)
        series.extend(s)
        labels.extend(l)
    # UEA class labels are 1-based ('1'..'20'): shifted to 0-based class
    # ids at build time.
    labels = np.asarray([float(l) for l in labels], dtype=np.float32) - 1.0
    temporal = [add_time(s[None])[0] for s in series]
    processed = process_all_interpolations(None, temporal, labels.astype(np.int64))
    return save_processed(processed, labels, os.path.join(root, "UEA/CharacterTrajectories"))


def build_tsr(dataset: str, root: str = "data/processed",
              raw_dir: str = "data/raw/TSR"):
    """A regression dataset of the TSER archive (the Beijing air-quality
    sets) from its ``<dataset>_TRAIN.ts`` file, real targets."""
    path = os.path.join(raw_dir, f"{dataset}_TRAIN.ts")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"TSR raw file {path} not found (zero-egress environment; "
            "download from the TSER archive first)."
        )
    series, targets = load_ts_file(path)
    targets = np.asarray([float(t) for t in targets], dtype=np.float32)
    temporal = [add_time(s[None])[0] for s in series]
    processed = process_all_interpolations(None, temporal, None)
    return save_processed(processed, targets, os.path.join(root, f"TSR/{dataset}"))


SPEECH_CLASSES = ("yes", "no", "up", "down", "left", "right", "on", "off",
                  "stop", "go")
SPEECH_SAMPLES = 16000   # one second at 16 kHz


def build_speech_commands(root: str = "data/processed",
                          raw_dir: str = "data/raw/SpeechCommands", *, device=None):
    """SpeechCommands MFCC dataset: ten classes of 16 kHz one-second int16
    clips (the extracted speech_commands_v0.02 archive under ``raw_dir``),
    10 MFCC channels computed on ``device`` (the card unless ``"cpu"`` is
    asked for) by ``data/audio.py``.  Clips of another length are
    dropped."""
    from scipy.io import wavfile

    from online_neural_cdes_tpu_torch.data.audio import mfcc

    if not os.path.isdir(raw_dir):
        raise FileNotFoundError(
            f"SpeechCommands raw audio not found under {raw_dir} "
            "(zero-egress environment)."
        )
    clips, labels = [], []
    for y, cls in enumerate(SPEECH_CLASSES):
        folder = os.path.join(raw_dir, cls)
        for fname in sorted(os.listdir(folder)):
            if not fname.endswith(".wav"):
                continue
            _, audio = wavfile.read(os.path.join(folder, fname))
            if len(audio) != SPEECH_SAMPLES:
                continue
            clips.append(audio.astype(np.float32) / 2**15)
            labels.append(y)
    feats = mfcc(np.stack(clips), device=device).cpu().numpy()   # (N, frames, 10)
    labels = np.asarray(labels, np.float32)
    temporal = add_time(feats)
    processed = process_all_interpolations(None, temporal, labels.astype(np.int64))
    return save_processed(
        processed, labels, os.path.join(root, "SpeechCommands/SpeechCommands")
    )


BUILDERS = {
    "toy": build_toy_bm,
    "character_trajectories": build_character_trajectories,
    "speech_commands": build_speech_commands,
}


def main(argv=None):
    """``<name> [--root DIR] [--raw-dir DIR] [--device D]``: a Beijing name
    goes to :func:`build_tsr`, any other to ``BUILDERS``; ``--device`` is
    where SpeechCommands' MFCCs are computed.  Prints the written npz's
    path."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if argv and not argv[0].startswith("--") else "toy"

    def flag(key):
        return argv[argv.index(key) + 1] if key in argv else None

    kw = {"root": flag("--root") or "data/processed"}
    if flag("--raw-dir") is not None:
        kw["raw_dir"] = flag("--raw-dir")
    if name == "speech_commands" and flag("--device") is not None:
        kw["device"] = flag("--device")
    if name.startswith("Beijing"):
        path = build_tsr(name, **kw)
    else:
        path = BUILDERS[name](**kw)
    print(path)
    return path


if __name__ == "__main__":
    main()
