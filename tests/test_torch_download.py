"""The port's data acquisition (tpu_unet_torch/data/download.py) offline: the
cases of tests/test_download.py against the port's module, with the URL
templates pointed at local ``file://`` fixtures or a local http.server, and
the JAX package's and the port's `download_isbi` splitting one served
volume into the same tree. Nothing reaches the network."""

import http.server
import io
import os
import threading
import zipfile
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
from PIL import Image

from tpu_unet.data import download as jax_download
from tpu_unet.data.synthetic import synthetic_instances
from tpu_unet_torch.data import download
from tpu_unet_torch.data.download import download_ctc, download_isbi
from tpu_unet_torch.data.ingest import load_ctc_test, load_ctc_training, load_isbi_training
from tpu_unet_torch.data.tiff import read_tiff
from tests.test_download import _blob_labels, _image


def _serve(handler):
    srv = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}/uc?export=download"


class _Quiet(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def reply(self, body: bytes, ctype: str, cookie=None):
        self.send_response(200)
        if cookie:
            self.send_header("Set-Cookie", cookie)
        self.send_header("Content-Type", ctype)
        self.end_headers()
        self.wfile.write(body)


def _zip(name: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr(f"{name}/unet.pth", b"not-a-real-torch-file")
    return buf.getvalue()


def test_download_ctc_extracts_reference_layout(tmp_path, monkeypatch):
    name = "DIC-C2DH-HeLa"
    src = tmp_path / "fixture" / name
    for sub in ("01", "01_ST/SEG", "01_GT/SEG"):
        (src / sub).mkdir(parents=True)
    for i in range(2):
        Image.fromarray(_image(seed=i)).save(src / "01" / f"t00{i}.tif")
        Image.fromarray(_blob_labels()).save(src / "01_ST" / "SEG" / f"man_seg00{i}.tif")
    Image.fromarray(_blob_labels()).save(src / "01_GT" / "SEG" / "man_seg000.tif")
    with zipfile.ZipFile(tmp_path / "fixture" / f"{name}.zip", "w") as z:
        for root, _, files in os.walk(src):
            for f in files:
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, tmp_path / "fixture"))
    monkeypatch.setattr(download, "CTC_URL",
                        "file://" + str(tmp_path / "fixture") + "/{name}.zip")

    folder = download_ctc(str(tmp_path / "data"), name)
    assert folder == str(tmp_path / "data" / f"{name}-training")
    assert os.path.isfile(os.path.join(folder, "01", "t001.tif"))
    assert len(load_ctc_training(folder, crop=20)) == 1     # the GT frame is reserved
    test = load_ctc_test(folder)
    assert len(test) == 1 and test.images[0].shape == (64, 64)
    assert download_ctc(str(tmp_path / "data"), name) == folder     # idempotent


def test_download_isbi_splits_multipage_tiff(tmp_path, monkeypatch):
    fix = tmp_path / "fixture"
    fix.mkdir()
    vols = [Image.fromarray(_image(seed=i)) for i in range(3)]
    vols[0].save(fix / "train-volume.tif", save_all=True, append_images=vols[1:])
    lab = Image.fromarray((_blob_labels() > 0).astype(np.uint8) * 255)
    lab.save(fix / "train-labels.tif", save_all=True, append_images=[lab, lab])
    monkeypatch.setattr(download, "ISBI_URL", "file://" + str(fix) + "/{t}-{folder}.tif")

    folder = download_isbi(str(tmp_path / "data"))
    for i in range(3):
        assert os.path.isfile(os.path.join(folder, "01", f"t{i:03d}.tif"))
        seg = os.path.join(folder, "01_GT", "SEG", f"man_seg{i:03d}.tif")
        (inst,) = read_tiff(seg)
        assert inst.dtype == np.uint16
        assert set(np.unique(inst)) == {0, 1, 2}
        np.testing.assert_array_equal(np.asarray(Image.open(seg)), inst)
    data = load_isbi_training(folder, crop=20)
    assert len(data) == 3 and data.targets[0].shape == (64, 64)


def test_download_isbi_builds_the_jax_tree(tmp_path, monkeypatch):
    """One served volume and label stack, split by both packages: the same
    files, frames equal, label ids equal (both compact components to 1..K
    in the order of their first pixel)."""
    fix = tmp_path / "fixture"
    fix.mkdir()
    rng = np.random.RandomState(3)
    vols = [Image.fromarray(_image(96, 80, seed=i)) for i in range(4)]
    vols[0].save(fix / "train-volume.tif", save_all=True, append_images=vols[1:])
    labs = [Image.fromarray((synthetic_instances(96, 80, 6, rng) > 0).astype(np.uint8) * 255)
            for _ in range(4)]
    labs[0].save(fix / "train-labels.tif", save_all=True, append_images=labs[1:])
    url = "file://" + str(fix) + "/{t}-{folder}.tif"
    monkeypatch.setattr(download, "ISBI_URL", url)
    monkeypatch.setattr(jax_download, "ISBI_URL", url)

    port = download_isbi(str(tmp_path / "port"))
    ref = jax_download.download_isbi(str(tmp_path / "jax"))
    listing = {os.path.relpath(os.path.join(r, f), ref)
               for r, _, fs in os.walk(ref) for f in fs}
    assert listing == {os.path.relpath(os.path.join(r, f), port)
                       for r, _, fs in os.walk(port) for f in fs}
    assert len([f for f in listing if "man_seg" in f]) == 4
    for rel in sorted(listing):
        if rel.endswith(("volume.tif", "labels.tif")):
            continue
        got, = read_tiff(os.path.join(port, rel))
        want = np.asarray(Image.open(os.path.join(ref, rel)))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if "man_seg" in rel:
            assert got.max() > 1                 # several components a frame


def test_download_error_raised_offline(tmp_path):
    with pytest.raises(download.DownloadError):
        download._fetch("http://localhost:1/nope.zip", str(tmp_path / "x.zip"), timeout=2.0)


def test_download_pretrained_gdrive_confirm_dance(tmp_path):
    payload = _zip("DIC-C2DH-HeLa")
    hits = []

    class Handler(_Quiet):
        def do_GET(self):
            q = parse_qs(urlparse(self.path).query)
            hits.append(q)
            assert q.get("id") == ["FAKE_ID"]
            if q.get("confirm") == ["tok123"]:
                self.reply(payload, "application/zip")
            else:
                self.reply(b"<html>virus scan warning</html>", "text/html",
                           cookie="download_warning_123=tok123; Path=/")

    srv, base = _serve(Handler)
    try:
        out = download.download_pretrained(str(tmp_path / "models"), "DIC-C2DH-HeLa",
                                           file_id="FAKE_ID", base_url=base)
        assert os.path.exists(os.path.join(out, "unet.pth"))
        assert len(hits) == 2
        again = download.download_pretrained(str(tmp_path / "models"), "DIC-C2DH-HeLa",
                                             file_id="FAKE_ID", base_url=base)
        assert again == out and len(hits) == 2
    finally:
        srv.shutdown()


def test_download_pretrained_unknown_name(tmp_path):
    with pytest.raises(download.DownloadError, match="no published"):
        download.download_pretrained(str(tmp_path), "NoSuchDataset")


def test_download_pretrained_gdrive_form_confirm(tmp_path):
    payload = _zip("PhC-C2DH-U373")
    hits = []

    class Handler(_Quiet):
        def do_GET(self):
            path = urlparse(self.path)
            q = parse_qs(path.query)
            hits.append((path.path, q))
            if (path.path == "/download" and q.get("confirm") == ["t"]
                    and q.get("uuid") == ["u-u-i-d"]):
                self.reply(payload, "application/octet-stream")
            else:
                port = self.server.server_address[1]
                self.reply((
                    '<!DOCTYPE html><html><body>'
                    f'<form id="download-form" action="http://127.0.0.1:{port}/download" '
                    'method="get">'
                    '<input type="hidden" name="id" value="FORM_ID">'
                    '<input type="hidden" name="export" value="download">'
                    '<input type="hidden" name="confirm" value="t">'
                    '<input type="hidden" name="uuid" value="u-u-i-d">'
                    '</form></body></html>').encode(), "text/html")

    srv, base = _serve(Handler)
    try:
        out = download.download_pretrained(str(tmp_path / "models"), "PhC-C2DH-U373",
                                           file_id="FORM_ID", base_url=base)
        assert os.path.exists(os.path.join(out, "unet.pth"))
        assert len(hits) == 2
        assert not os.path.exists(tmp_path / "models" / "PhC-C2DH-U373.zip")
    finally:
        srv.shutdown()


def test_download_pretrained_unresolvable_html_raises(tmp_path):
    class Handler(_Quiet):
        def do_GET(self):
            self.reply(b"<html><body>Quota exceeded</body></html>", "text/html")

    srv, base = _serve(Handler)
    try:
        with pytest.raises(download.DownloadError):
            download.download_pretrained(str(tmp_path / "models"), "ISBI2012",
                                         file_id="NO_FORM", base_url=base)
        assert not os.path.exists(tmp_path / "models" / "ISBI2012.zip")
    finally:
        srv.shutdown()
