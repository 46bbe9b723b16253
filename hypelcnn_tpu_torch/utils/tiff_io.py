"""Image output without PIL: baseline uncompressed TIFF (and ``.npy``).

:func:`imwrite` writes a 2-D ``uint8`` class map (grayscale) or an
``H x W x 3`` ``uint8`` RGB image as one strip, with the tags ImageWidth,
ImageLength, BitsPerSample, Compression (1, none), PhotometricInterpretation,
StripOffsets, SamplesPerPixel, RowsPerStrip and StripByteCounts. A path
ending in ``.npy`` is written with ``np.save``, as the JAX package does.
Reading TIFF images comes with the real dataset loaders.
"""

from __future__ import annotations

import struct

import numpy as np

_SHORT, _LONG = 3, 4
_IFD_OFFSET = 8


def imwrite(path: str, data: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, data)
        return
    data = np.ascontiguousarray(data)
    if data.dtype != np.uint8 or not (data.ndim == 2 or (data.ndim == 3 and data.shape[2] == 3)):
        raise ValueError("imwrite writes a 2-D or H x W x 3 uint8 array as TIFF, got "
                         f"{data.dtype} of shape {data.shape}")
    height, width = data.shape[:2]
    samples = 1 if data.ndim == 2 else 3
    n_tags = 9
    extra_offset = _IFD_OFFSET + 2 + 12 * n_tags + 4
    bits_per_sample = struct.pack("<3H", 8, 8, 8) if samples == 3 else b""
    pixel_offset = extra_offset + len(bits_per_sample)
    tags = [
        (256, _LONG, 1, width),                        # ImageWidth
        (257, _LONG, 1, height),                       # ImageLength
        (258, _SHORT, samples, 8 if samples == 1 else extra_offset),  # BitsPerSample
        (259, _SHORT, 1, 1),                           # Compression: none
        (262, _SHORT, 1, 1 if samples == 1 else 2),    # Photometric: BlackIsZero / RGB
        (273, _LONG, 1, pixel_offset),                 # StripOffsets
        (277, _SHORT, 1, samples),                     # SamplesPerPixel
        (278, _LONG, 1, height),                       # RowsPerStrip
        (279, _LONG, 1, data.nbytes),                  # StripByteCounts
    ]
    with open(path, "wb") as fid:
        fid.write(b"II" + struct.pack("<HI", 42, _IFD_OFFSET))
        fid.write(struct.pack("<H", n_tags))
        for tag, kind, count, value in tags:
            fid.write(struct.pack("<HHII", tag, kind, count, value))
        fid.write(struct.pack("<I", 0))
        fid.write(bits_per_sample)
        fid.write(data.tobytes())


def read_tags(path: str) -> dict:
    """``{tag: value}`` of the first IFD of a little-endian TIFF, for the
    SHORT and LONG tags that hold one value (no image data is decoded)."""
    with open(path, "rb") as fid:
        head = fid.read(8)
        if head[:2] != b"II" or struct.unpack("<H", head[2:4])[0] != 42:
            raise ValueError(f"{path} is not a little-endian TIFF")
        fid.seek(struct.unpack("<I", head[4:8])[0])
        (n_tags,) = struct.unpack("<H", fid.read(2))
        tags = {}
        for _ in range(n_tags):
            tag, kind, count, raw = struct.unpack("<HHI4s", fid.read(12))
            if count == 1 and kind in (_SHORT, _LONG):
                tags[tag] = struct.unpack_from("<H" if kind == _SHORT else "<I", raw)[0]
        return tags
