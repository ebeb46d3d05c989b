"""Dataset download helpers (counterpart of `mlsp_tpu/data/download.py`,
itself the reference's `PointDA/data/download.py` and
`PointSegDA/data/download.py`): fetch an archive from Google Drive with the
`gdown` program and extract it. Needs a network and `gdown` on the PATH;
without them it raises and names `--synthetic`."""

from __future__ import annotations

import os
import subprocess
import zipfile

POINTDA_GDRIVE_ID = "1-LfJWL5geF9h0Z2QpdTL0n4lShy8wy2J"
POINTSEGDA_GDRIVE_ID = "165lBJ1cMdOyZZPrO1BcNRfvXdVuCWiQW"


def download_pointda(dataroot: str = "./data") -> str:
    """Fetch and extract PointDA_data.zip under `dataroot`; returns it."""
    return _gdown_extract(POINTDA_GDRIVE_ID, dataroot, "PointDA_data.zip")


def download_pointsegda(dataroot: str = "./data") -> str:
    """Fetch and extract PointSegDAdataset.zip under `dataroot`; returns
    it."""
    return _gdown_extract(POINTSEGDA_GDRIVE_ID, dataroot,
                          "PointSegDAdataset.zip")


def _gdown_extract(file_id: str, dataroot: str, name: str) -> str:
    """An archive already at `dataroot/name` is not fetched again."""
    os.makedirs(dataroot, exist_ok=True)
    dest = os.path.join(dataroot, name)
    if not os.path.exists(dest):
        try:
            subprocess.run(
                ["gdown", f"https://drive.google.com/uc?id={file_id}", "-O",
                 dest],
                check=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError(
                f"could not download {name} (no network/gdown?). Place the "
                f"extracted dataset under {dataroot} manually, or run any "
                f"trainer with --synthetic 1."
            ) from e
    if dest.endswith(".zip"):
        with zipfile.ZipFile(dest) as z:
            z.extractall(dataroot)
    return dataroot
