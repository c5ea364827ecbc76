"""Dataset acquisition (counterpart of ``tpu_unet/data/download.py``).

Fetches the Cell Tracking Challenge archives and the ISBI2012 multipage
TIFFs into the reference's on-disk layout (``data/{NAME}-{training|challenge}``
with ``0N`` image dirs and ``0N_GT/SEG`` labels), so the loaders of
`tpu_unet_torch.data.ingest` read a tree this module made and one the JAX
package or the reference made alike. The ISBI volumes are split with the
port's TIFF codec and their labels made instance masks with the port's
connected components, on the CPU.

Uses stdlib urllib. `download_pretrained` fetches the reference's published
torch checkpoints from Google Drive; the CLI's TESTING mode serves a
fetched ``.pth`` directly (``convert.load_reference_checkpoint``).

Without network access every fetch raises `DownloadError`; the CLI's
``--synthetic`` fixture needs none. The ISBI host (brainiac2.mit.edu) is
defunct upstream.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional, Tuple

import numpy as np

CTC_URL = "http://data.celltrackingchallenge.net/{kind}-datasets/{name}.zip"
ISBI_URL = "http://brainiac2.mit.edu/isbi_challenge/sites/default/files/{t}-{folder}.tif"


class DownloadError(RuntimeError):
    pass


def _fetch(url: str, dest: str, timeout: float = 60.0) -> None:
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(dest, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except Exception as e:  # pragma: no cover - network dependent
        raise DownloadError(f"failed to fetch {url}: {e}") from e


def download_ctc(data_dir: str, name: str, kind: str = "training") -> str:
    """Download + extract one CTC dataset to ``{data_dir}/{name}-{kind}``."""
    folder = os.path.join(data_dir, f"{name}-{kind}")
    if os.path.isdir(folder):
        return folder
    os.makedirs(data_dir, exist_ok=True)
    zpath = os.path.join(data_dir, f"{name}.zip")
    _fetch(CTC_URL.format(kind=kind, name=name), zpath)
    with zipfile.ZipFile(zpath) as z:
        z.extractall(data_dir)
    os.rename(os.path.join(data_dir, name), folder)
    os.remove(zpath)
    return folder


def download_isbi(data_dir: str, kind: str = "training") -> str:
    """Download ISBI2012 and split the multipage TIFFs into the CTC-style
    layout: frames as ``01/t{i:03d}.tif``, label frames as uint16 instance
    masks ``01_GT/SEG/man_seg{i:03d}.tif`` (4-connected components of the
    foreground, ids 1..K in the order of each component's first pixel)."""
    import torch

    from tpu_unet_torch.data.tiff import read_tiff, write_tiff
    from tpu_unet_torch.ops.cc import connected_components

    t = "train" if kind == "training" else "test"
    folder = os.path.join(data_dir, f"ISBI2012-{kind}")
    if os.path.isdir(folder):
        return folder
    os.makedirs(folder, exist_ok=True)
    folders: Tuple[str, ...] = ("volume", "labels") if kind == "training" else ("volume",)
    for kindname in folders:
        tif = os.path.join(folder, f"{t}-{kindname}.tif")
        _fetch(ISBI_URL.format(t=t, folder=kindname), tif)
        seq = "01" if kindname == "volume" else "01_GT"
        outdir = os.path.join(folder, seq, "SEG") if kindname == "labels" \
            else os.path.join(folder, seq)
        os.makedirs(outdir, exist_ok=True)
        for i, frame in enumerate(read_tiff(tif)):
            if kindname == "volume":
                write_tiff(os.path.join(outdir, f"t{i:03d}.tif"), frame)
            else:
                fg = frame > 0
                lab = connected_components(torch.from_numpy(fg)).numpy()
                # compact: background 0, components 1..K by their labels' order
                ids = np.unique(lab[fg])
                compact = np.where(fg, np.searchsorted(ids, lab) + 1, 0)
                write_tiff(os.path.join(outdir, f"man_seg{i:03d}.tif"),
                           compact.astype(np.uint16))
    return folder


def download_all(data_dir: str) -> None:
    """All three workloads: DIC-HeLa and PhC-U373 (training and challenge)
    and ISBI2012."""
    for name in ("DIC-C2DH-HeLa", "PhC-C2DH-U373"):
        for kind in ("training", "challenge"):
            download_ctc(data_dir, name, kind)
    for kind in ("training", "challenge"):
        download_isbi(data_dir, kind)


# --- pretrained checkpoints ---------------------------------------------------

GDRIVE_URL = "https://docs.google.com/uc?export=download"

# The reference's published pretrained torch checkpoints.
PRETRAINED_MODEL_IDS = {
    "ISBI2012": "1tivQbiNkaQLlEN5ck5JYHyH1hczH_Kgq",
    "DIC-C2DH-HeLa": "1Fn5_wSYEFX50orh_qYWDc2BkWjCByRmC",
    "PhC-C2DH-U373": "1SWuBGSgQJvR2yBZpR4CSEoOQj2_pGfVI",
}


def _parse_drive_interstitial(html: str):
    """Extract (action_url, params) from Drive's download-warning HTML form.
    Since ~2022 the confirm token rides in hidden form inputs (the
    ``download_warning`` cookie is gone); the form posts to
    drive.usercontent.google.com with id/export/confirm/uuid fields."""
    import re

    m = re.search(r'<form[^>]*action="([^"]+)"', html)
    if not m:
        return None
    action = m.group(1).replace("&amp;", "&")
    params = {}
    for name, value in re.findall(
            r'<input[^>]*name="([^"]+)"[^>]*value="([^"]*)"', html):
        params[name] = value
    return action, params


def fetch_gdrive(file_id: str, dest: str, *, base_url: str = GDRIVE_URL,
                 timeout: float = 60.0) -> None:
    """Fetch a Google-Drive file by id: the first GET may answer with a virus-scan interstitial instead of the
    payload. Two confirm mechanisms are handled: the legacy
    ``download_warning`` cookie (the reference's mechanism) and the current
    HTML form whose hidden inputs carry the confirm token/uuid. Stdlib
    cookie-aware urllib, streamed to `dest`; an interstitial that cannot be
    resolved raises DownloadError rather than leaving HTML on disk."""
    import http.cookiejar
    import urllib.request
    from urllib.parse import urlencode

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))

    def get(url, params):
        return opener.open(f"{url}&{urlencode(params)}"
                           if "?" in url
                           else f"{url}?{urlencode(params)}",
                           timeout=timeout)

    def stream_to_dest(r) -> bytes:
        """Write the response to dest; returns the first KB for sniffing."""
        head = b""
        with r, open(dest, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                if len(head) < 1024:
                    head += chunk[:1024]
                f.write(chunk)
        return head

    try:
        r = get(base_url, {"id": file_id})
        token = next((c.value for c in jar
                      if c.name.startswith("download_warning")), None)
        if token:
            r.close()
            r = get(base_url, {"id": file_id, "confirm": token})
        head = stream_to_dest(r)
        if head.lstrip()[:15].lower() not in (b"<!doctype html>",) and \
                not head.lstrip().lower().startswith(b"<html"):
            return
        # The payload was the HTML interstitial: parse the confirm form.
        with open(dest, "r", errors="replace") as f:
            parsed = _parse_drive_interstitial(f.read())
        os.remove(dest)
        if parsed is None:
            raise DownloadError(
                f"drive id {file_id}: interstitial page with no download "
                f"form (quota exceeded or file removed)")
        action, params = parsed
        params.setdefault("id", file_id)
        head = stream_to_dest(get(action, params))
        if head.lstrip().lower().startswith((b"<!doctype", b"<html")):
            os.remove(dest)
            raise DownloadError(
                f"drive id {file_id}: still served HTML after form confirm")
    except DownloadError:
        raise
    except Exception as e:  # pragma: no cover - network dependent
        raise DownloadError(f"failed to fetch drive id {file_id}: {e}") from e


def download_pretrained(models_dir: str, name: str, *,
                        file_id: Optional[str] = None,
                        base_url: str = GDRIVE_URL) -> str:
    """Fetch + extract one pretrained checkpoint zip. Skips if
    ``{models_dir}/{name}`` already exists, like the reference. The extracted
    ``.pth`` is served by ``python -m tpu_unet_torch -m TESTING -n
    <path>.pth`` (``convert.load_reference_checkpoint``)."""
    if file_id is None:
        try:
            file_id = PRETRAINED_MODEL_IDS[name]
        except KeyError:
            raise DownloadError(
                f"no published pretrained checkpoint for {name!r}; known: "
                f"{sorted(PRETRAINED_MODEL_IDS)}") from None
    os.makedirs(models_dir, exist_ok=True)
    target = os.path.join(models_dir, name)
    if os.path.isdir(target):
        return target
    zpath = os.path.join(models_dir, f"{name}.zip")
    try:
        fetch_gdrive(file_id, zpath, base_url=base_url)
        try:
            with zipfile.ZipFile(zpath) as z:
                z.extractall(models_dir)
        except zipfile.BadZipFile as e:
            # callers are documented to catch DownloadError, and a stale
            # partial zip must not poison the retry
            raise DownloadError(
                f"pretrained {name}: fetched file is not a zip ({e})") from e
    finally:
        if os.path.exists(zpath):
            os.remove(zpath)
    return target


if __name__ == "__main__":  # python -m tpu_unet_torch.data.download [DATA_DIR]
    import sys

    download_all(sys.argv[1] if len(sys.argv) > 1 else "data")
    for _name in PRETRAINED_MODEL_IDS:
        try:
            download_pretrained("models", _name)
        except DownloadError as e:
            print(f"pretrained {_name}: {e}")
