"""Baseline TIFF in numpy: the port's image codec (the JAX package reads and
writes its TIFFs through Pillow; the port depends on numpy only).

`read_tiff` decodes every page of an uncompressed grayscale TIFF, little-
or big-endian, in uint8, uint16, uint32, int32 or float32, stored in strips
of any RowsPerStrip. `write_tiff` writes one uncompressed little-endian page
as a single strip. Anything else (compression, a predictor, a palette or
colour, tiles, more than one sample per pixel, BigTIFF) raises a
`ValueError` that names the tag and its value: nothing is decoded silently.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# TIFF field type -> struct code, for the integer types (the tags the
# decoder reads are integers)
_INT_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}

_TAG_NAMES = {258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
              277: "SamplesPerPixel", 317: "Predictor", 322: "TileWidth",
              339: "SampleFormat"}

# (SampleFormat, BitsPerSample) -> numpy kind and size; the only pixel types
# read and written.
_DTYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 32): "i4", (3, 32): "f4"}
_FORMATS = {np.dtype(v): k for k, v in _DTYPES.items()}

# tag -> the only value accepted (absent tags take the TIFF default)
_REQUIRED = {259: 1, 262: 1, 277: 1, 317: 1}


def _unsupported(path: str, tag: int, value) -> ValueError:
    return ValueError(f"TIFF {path}: {_TAG_NAMES[tag]} (tag {tag}) = "
                      f"{value} is not supported (baseline uncompressed grayscale "
                      f"only)")


def _ifd(buf: bytes, offset: int, bo: str) -> Tuple[Dict[int, Tuple[int, ...]], int]:
    """The integer-valued tags of the IFD at `offset` ({tag: values}) and
    the next IFD's offset (0 after the last page)."""
    (n,) = struct.unpack_from(bo + "H", buf, offset)
    tags: Dict[int, Tuple[int, ...]] = {}
    for k in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", buf, offset + 2 + 12 * k)
        if typ not in _INT_TYPES:
            continue                     # rationals, text: nothing the decoder needs
        at = offset + 2 + 12 * k + 8
        if struct.calcsize(bo + _INT_TYPES[typ]) * count > 4:
            (at,) = struct.unpack_from(bo + "I", buf, at)
        tags[tag] = struct.unpack_from(f"{bo}{count}{_INT_TYPES[typ]}", buf, at)
    (nxt,) = struct.unpack_from(bo + "I", buf, offset + 2 + 12 * n)
    return tags, nxt


def _page(buf: bytes, tags: Dict[int, Tuple[int, ...]], bo: str, path: str
          ) -> np.ndarray:
    for tag, want in _REQUIRED.items():
        value = tags.get(tag, (want,))[0]
        if value != want:
            raise _unsupported(path, tag, value)
    if 322 in tags:
        raise _unsupported(path, 322, tags[322][0])
    w, h = tags[256][0], tags[257][0]
    key = (tags.get(339, (1,))[0], tags.get(258, (1,))[0])
    if key not in _DTYPES:
        tag = 339 if key[1] in (8, 16, 32) else 258
        raise _unsupported(path, tag, key[0] if tag == 339 else key[1])
    dtype = np.dtype(bo + _DTYPES[key])
    nbytes = w * h * dtype.itemsize
    offsets = tags[273]
    counts = tags.get(279)
    if counts is None:                   # one strip holding the whole page
        counts = (nbytes,)
    data = b"".join(buf[o:o + c] for o, c in zip(offsets, counts))
    if len(data) < nbytes:
        raise ValueError(f"TIFF {path}: strips hold {len(data)} bytes, a {h}x{w} "
                         f"{dtype.name} page needs {nbytes}")
    page = np.frombuffer(data, dtype, count=w * h).reshape(h, w)
    return page.astype(dtype.newbyteorder("="))


def read_tiff(path: str) -> List[np.ndarray]:
    """Every page of the TIFF at `path`, each an [H, W] array in the file's
    pixel type (native byte order)."""
    with open(path, "rb") as f:
        buf = f.read()
    order = buf[:2]
    if order not in (b"II", b"MM"):
        raise ValueError(f"TIFF {path}: byte order {order!r} is not a TIFF header")
    bo = "<" if order == b"II" else ">"
    magic, offset = struct.unpack_from(bo + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"TIFF {path}: version {magic} is not supported "
                         f"(baseline TIFF is 42; 43 is BigTIFF)")
    pages, seen = [], set()
    while offset and offset not in seen:
        seen.add(offset)
        tags, offset = _ifd(buf, offset, bo)
        pages.append(_page(buf, tags, bo, path))
    return pages


def write_tiff(path: str, array: np.ndarray) -> None:
    """Write the 2-D `array` (uint8, uint16, uint32, int32 or float32) as
    one uncompressed little-endian page in a single strip."""
    arr = np.asarray(array)
    if arr.ndim != 2 or 0 in arr.shape:
        raise ValueError(f"write_tiff takes a non-empty 2-D array, got shape {arr.shape}")
    dtype = arr.dtype.newbyteorder("=")
    if dtype not in _FORMATS:
        raise ValueError(f"write_tiff takes uint8, uint16, uint32, int32 or float32, "
                         f"got {arr.dtype}")
    fmt, bits = _FORMATS[dtype]
    data = np.ascontiguousarray(arr, dtype.newbyteorder("<")).tobytes()
    h, w = arr.shape
    ifd_at = 8 + len(data) + len(data) % 2          # IFDs start on a word boundary
    entries = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1), (262, 3, 1),
               (273, 4, 8), (277, 3, 1), (278, 4, h), (279, 4, len(data)),
               (284, 3, 1), (339, 3, fmt)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, 1)
        + struct.pack("<HH" if typ == 3 else "<I", *((value, 0) if typ == 3 else (value,)))
        for tag, typ, value in entries) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_at))
        f.write(data + b"\0" * (len(data) % 2))
        f.write(ifd)
