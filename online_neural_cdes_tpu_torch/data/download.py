"""Download helpers for the raw archives, on the standard library.

Counterpart of the JAX package's ``data/download.py``, with its names and
behaviour: ``download_url`` fetches a file unless it exists,
``download_zip`` fetches and extracts an archive into an empty folder,
``unzip`` and ``untar`` extract (``untar`` with the "data" filter, which
refuses absolute paths, traversal and special files).  The builders never
call them: they read raw files already on disk and raise
``FileNotFoundError`` when those are missing.
"""

from __future__ import annotations

import logging
import os
import tarfile
import urllib.request
import zipfile

logger = logging.getLogger(__name__)

SPEECH_COMMANDS_URL = "http://download.tensorflow.org/data/speech_commands_v0.02.tar.gz"
UEA_URL = "http://www.timeseriesclassification.com/Downloads/{name}.zip"


def mkdir_if_not_exists(loc: str, file: bool = False) -> bool:
    existed = os.path.exists(loc)
    os.makedirs(os.path.dirname(loc) if file else loc, exist_ok=True)
    return existed


def download_url(url: str, loc: str):
    if not os.path.exists(loc):
        logger.info("downloading %s -> %s", url, loc)
        urllib.request.urlretrieve(url, loc)


def unzip(file: str, loc: str):
    with zipfile.ZipFile(file, "r") as zf:
        zf.extractall(loc)


def untar(file: str, loc: str):
    with tarfile.open(file, "r") as tf:
        # "data" filter: reject absolute paths / traversal / special files
        # (the Python 3.14 default; explicit here for 3.12+ behaviour and
        # basic archive-hygiene on downloaded corpora).
        tf.extractall(loc, filter="data")


def download_zip(folder: str, name: str, url: str, do_unzip: bool = True):
    """Download <url> to <folder>/<name>.zip and optionally extract
    (no-op if the folder already has content)."""
    os.makedirs(folder, exist_ok=True)
    if os.listdir(folder):
        logger.info("files exist in %s; delete to re-download", folder)
        return None
    location = os.path.join(folder, f"{name}.zip")
    download_url(url, location)
    if do_unzip:
        unzip(location, folder)
    return location
