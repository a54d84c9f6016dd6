"""Dataset builders: write the processed ``improved-neural-cdes_data.npz``
of a dataset.

PyTorch port's counterpart of the JAX package's ``data/builders.py``.
``build_toy_bm``, the self-contained synthetic dataset of the smoke
suites and tests, is ported whole and writes the same files as the JAX
builder.  The builders of the raw archives (UEA ``.ts`` files, Speech
Commands wav files, the TSR archive) are ROADMAP item 16b and raise.

    python -m online_neural_cdes_tpu_torch.data.builders toy --root data/processed
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


def _raw_builder(what: str):
    raise NotImplementedError(
        f"the {what} builder is not ported yet (ROADMAP item 16b: the raw-archive "
        "builders, ts_format, audio, mimic_raw and download); the JAX package's "
        "data.builders writes the same npz"
    )


def build_character_trajectories(root: str = "data/processed",
                                 raw_dir: str = "data/raw/UEA"):
    """UEA CharacterTrajectories from .ts files: ROADMAP item 16b."""
    _raw_builder("CharacterTrajectories")


def build_tsr(dataset: str, root: str = "data/processed",
              raw_dir: str = "data/raw/TSR"):
    """The Beijing air-quality regression datasets: ROADMAP item 16b."""
    _raw_builder(f"TSR {dataset}")


def build_speech_commands(root: str = "data/processed",
                          raw_dir: str = "data/raw/SpeechCommands"):
    """The SpeechCommands MFCC dataset: ROADMAP item 16b."""
    _raw_builder("SpeechCommands")


BUILDERS = {
    "toy": build_toy_bm,
    "character_trajectories": build_character_trajectories,
    "speech_commands": build_speech_commands,
}


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "toy"
    root = "data/processed"
    if "--root" in sys.argv:
        root = sys.argv[sys.argv.index("--root") + 1]
    if name.startswith("Beijing"):
        print(build_tsr(name, root=root))
    else:
        print(BUILDERS[name](root=root))
