"""Scene image I/O in numpy alone: TIFF, BMP and ``.npy``.

The JAX package reads scenes through PIL (``hypelcnn_tpu/utils/tiff_io.py``)
and AVON's masks through imageio; neither is installed beside the port, so
this module reads and writes the files itself, with the same contract:

- :func:`imread` returns what the JAX package's ``imread`` returns: ``.npy``
  through ``np.load``; a multi-page TIFF stacked along the last axis; a
  single page as a 2-D array, or ``H x W x 3`` for an 8-bit RGB page. It
  reads little-endian, strip-organized TIFFs of ``uint8``, ``uint16``,
  ``int16`` (returned as ``int32``, as PIL widens them), ``int32`` or
  ``float32`` samples, uncompressed (1), LZW (5), Deflate (8, 32946) or
  PackBits (32773), with predictor 1 or 2. Anything else (tiles,
  big-endian, JPEG, several samples a pixel beyond RGB) raises a
  ``ValueError`` that names the tag and the file. LZW is decoded in
  Python, one code at a time: slow for a large scene.
- :func:`imwrite` writes a 2-D array or an ``H x W x 3`` ``uint8`` RGB image
  as one uncompressed page, and any other 3-D array as one uncompressed page
  per band. A path ending in ``.npy`` goes through ``np.save``.
- :func:`read_bmp` returns what ``imageio.v2.imread`` returns for an
  uncompressed 1-bit (``bool`` for a black-and-white palette), 8-bit or
  24-bit BMP; :func:`write_bmp` writes a ``bool`` mask as a 1-bit BMP.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SHORT, _LONG = 3, 4
# the value formats of the tag types this reader parses
_TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d"}
_TAG_NAMES = {
    256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
    262: "PhotometricInterpretation", 266: "FillOrder", 273: "StripOffsets",
    277: "SamplesPerPixel", 278: "RowsPerStrip", 279: "StripByteCounts",
    284: "PlanarConfiguration", 317: "Predictor", 322: "TileWidth", 323: "TileLength",
    324: "TileOffsets", 325: "TileByteCounts", 338: "ExtraSamples", 339: "SampleFormat",
}
# SampleFormat (1 unsigned, 2 signed, 3 float) and bits -> dtype
_DTYPES = {(1, 8): "<u1", (1, 16): "<u2", (2, 16): "<i2", (2, 32): "<i4", (3, 32): "<f4"}
_SAMPLE_FORMATS = {np.dtype(v): k[0] for k, v in _DTYPES.items()}
_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = 1, 5, 8, 32946, 32773


def _refuse(path, tag, value, why):
    raise ValueError(f"{path}: TIFF tag {_TAG_NAMES.get(tag, tag)} ({tag}) = {value}: {why}")


def _read_ifds(fid, path):
    """Every IFD of the file, in chain order, as ``{tag: tuple of values}``
    (``None`` for a tag of a type this reader does not parse)."""
    head = fid.read(8)
    if head[:2] == b"MM":
        raise ValueError(f"{path}: big-endian TIFF (byte order 'MM') is not read")
    if head[:2] != b"II" or struct.unpack("<H", head[2:4])[0] != 42:
        raise ValueError(f"{path}: not a little-endian TIFF (header {head[:4]!r})")
    offset = struct.unpack("<I", head[4:8])[0]
    ifds, seen = [], set()
    while offset:
        if offset in seen:
            raise ValueError(f"{path}: the IFD chain loops at offset {offset}")
        seen.add(offset)
        fid.seek(offset)
        (count,) = struct.unpack("<H", fid.read(2))
        entries = fid.read(12 * count)
        (offset,) = struct.unpack("<I", fid.read(4))
        tags = {}
        for i in range(count):
            tag, kind, n, raw = struct.unpack_from("<HHI4s", entries, 12 * i)
            fmt = _TYPE_FORMATS.get(kind)
            if fmt is None:
                tags[tag] = None
                continue
            size = struct.calcsize("<" + fmt) * n
            if size <= 4:
                buf = raw[:size]
            else:
                here = fid.tell()
                fid.seek(struct.unpack("<I", raw)[0])
                buf = fid.read(size)
                fid.seek(here)
            tags[tag] = struct.unpack(f"<{n}{fmt}", buf)
        ifds.append(tags)
    return ifds


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF's LZW: MSB-first codes of 9 to 12 bits, Clear 256, EOI 257, the
    code width growing one code early."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    data = bytes(data) + b"\0\0\0"
    total_bits = (len(data) - 3) * 8
    bit_pos, width, prev = 0, 9, None
    while bit_pos + width <= total_bits and len(out) < expected:
        byte = bit_pos >> 3
        chunk = (data[byte] << 16) | (data[byte + 1] << 8) | data[byte + 2]
        code = (chunk >> (24 - (bit_pos & 7) - width)) & ((1 << width) - 1)
        bit_pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW data: code {code} past the table's {len(table)}")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _page_layout(tags, path):
    """``(height, width, samples, dtype)`` of a page, refusing what is not read."""
    for tile in (322, 323, 324, 325):
        if tile in tags:
            _refuse(path, tile, tags[tile], "tiled TIFFs are not read, only strips")
    for tag in (256, 257, 273, 279):
        if tag not in tags:
            raise ValueError(f"{path}: TIFF tag {_TAG_NAMES[tag]} ({tag}) is missing")
    samples = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,) * samples)
    formats = tags.get(339, (1,) * samples)
    if len(set(bits)) != 1:
        _refuse(path, 258, bits, "samples of different widths are not read")
    if len(set(formats)) != 1:
        _refuse(path, 339, formats, "samples of different formats are not read")
    dtype = _DTYPES.get((formats[0], bits[0]))
    if dtype is None:
        _refuse(path, 258, bits, f"with SampleFormat (339) {formats[0]}: only uint8, uint16, "
                                 "int16, int32 and float32 samples are read")
    compression = tags.get(259, (1,))[0]
    if compression not in (_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS):
        _refuse(path, 259, compression,
                "only none (1), LZW (5), Deflate (8, 32946) and PackBits (32773) are read")
    if tags.get(317, (1,))[0] not in (1, 2):
        _refuse(path, 317, tags[317], "only predictor 1 or 2 is read")
    if tags.get(266, (1,))[0] != 1:
        _refuse(path, 266, tags[266], "only fill order 1 is read")
    if 338 in tags:
        _refuse(path, 338, tags[338], "extra samples are not read")
    photometric = tags.get(262, (None,))[0]
    if samples == 1:
        if photometric != 1:
            _refuse(path, 262, photometric, "a one-sample page must be BlackIsZero (1)")
    elif samples == 3:
        if dtype != "<u1" or photometric != 2:
            _refuse(path, 277, samples, "three samples a pixel are read only as 8-bit RGB")
        if tags.get(284, (1,))[0] != 1:
            _refuse(path, 284, tags[284], "only chunky (1) planar configuration is read")
    else:
        _refuse(path, 277, samples, "several samples a pixel beyond RGB are not read")
    return tags[257][0], tags[256][0], samples, np.dtype(dtype)


def _read_page(fid, tags, path) -> np.ndarray:
    height, width, samples, dtype = _page_layout(tags, path)
    compression = tags.get(259, (1,))[0]
    offsets, counts = tags[273], tags[279]
    rows_per_strip = min(tags.get(278, (height,))[0], height) or height
    row_bytes = width * samples * dtype.itemsize
    if len(offsets) != len(counts) or len(offsets) < -(-height // rows_per_strip):
        raise ValueError(f"{path}: {len(offsets)} strip offsets and {len(counts)} byte counts "
                       f"for {height} rows of {rows_per_strip} a strip")
    page = np.empty(height * row_bytes, dtype=np.uint8)
    view = memoryview(page)
    for strip, (offset, count) in enumerate(zip(offsets, counts)):
        start = strip * rows_per_strip * row_bytes
        if start >= page.size:
            break
        need = min(rows_per_strip * row_bytes, page.size - start)
        fid.seek(offset)
        if compression == _NONE:
            got = fid.readinto(view[start:start + need])
        else:
            raw = fid.read(count)
            try:
                if compression == _LZW:
                    raw = _lzw_decode(raw, need)
                elif compression == _PACKBITS:
                    raw = _packbits_decode(raw, need)
                else:
                    raw = zlib.decompress(raw)
            except (ValueError, zlib.error) as err:
                raise ValueError(f"{path}: strip {strip}: {err}") from err
            got = min(len(raw), need)
            page[start:start + got] = np.frombuffer(raw, dtype=np.uint8, count=got)
        if got < need:
            raise ValueError(f"{path}: strip {strip} holds {got} bytes, {need} expected")
    shape = (height, width) if samples == 1 else (height, width, samples)
    array = page.view(dtype).reshape(height, width, samples)
    if tags.get(317, (1,))[0] == 2 and compression in (_LZW, _DEFLATE, _ADOBE_DEFLATE):
        # horizontal differencing (libtiff applies it with LZW and Deflate
        # only): each sample adds the one to its left, wrapping in the
        # unsigned integers of the sample's width
        unsigned = array.view(f"<u{dtype.itemsize}")
        np.cumsum(unsigned, axis=1, dtype=unsigned.dtype, out=unsigned)
    # PIL widens int16 samples to int32
    out_dtype = np.int32 if dtype == np.int16 else dtype.newbyteorder("=")
    return array.reshape(shape).astype(out_dtype, copy=False)


def imread(path: str) -> np.ndarray:
    """Read an image or scene; a multi-page TIFF stacks its pages along the last axis."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as fid:
        ifds = _read_ifds(fid, path)
        if not ifds:
            raise ValueError(f"{path}: the TIFF holds no page")
        first = _read_page(fid, ifds[0], path)
        if len(ifds) == 1:
            return first
        out = np.empty(first.shape + (len(ifds),), dtype=first.dtype)
        out[..., 0] = first
        for i, tags in enumerate(ifds[1:], start=1):
            page = _read_page(fid, tags, path)
            if page.shape != first.shape or page.dtype != first.dtype:
                raise ValueError(f"{path}: page {i} is {page.dtype} {page.shape}, page 0 "
                                 f"{first.dtype} {first.shape}; pages do not stack")
            out[..., i] = page
        return out


def _pages(data: np.ndarray) -> list:
    if data.ndim == 2 or (data.ndim == 3 and data.shape[2] == 3 and data.dtype == np.uint8):
        return [data]
    if data.ndim == 3:
        return [data[:, :, i] for i in range(data.shape[2])]
    raise ValueError(f"imwrite writes a 2-D or 3-D array as TIFF, got shape {data.shape}")


def imwrite(path: str, data: np.ndarray) -> None:
    """Write an image or scene; a 3-D array that is not a ``uint8`` RGB image
    becomes one uncompressed page per band."""
    if path.endswith(".npy"):
        np.save(path, data)
        return
    if data.dtype.newbyteorder("<") not in _SAMPLE_FORMATS:
        raise ValueError("imwrite writes uint8, uint16, int16, int32 or float32 TIFFs, got "
                         f"{data.dtype} of shape {data.shape}")
    with open(path, "wb") as fid:
        fid.write(b"II" + struct.pack("<HI", 42, 8))
        pages = _pages(data)
        for index, page in enumerate(pages):
            page = np.ascontiguousarray(page, dtype=page.dtype.newbyteorder("<"))
            height, width = page.shape[:2]
            samples = 1 if page.ndim == 2 else 3
            n_tags = 10
            ifd_at = fid.tell()
            extra_at = ifd_at + 2 + 12 * n_tags + 4
            bits = struct.pack("<3H", 8, 8, 8) if samples == 3 else b""
            pixels_at = extra_at + len(bits)
            next_at = pixels_at + page.nbytes
            next_at += next_at % 2  # an IFD starts on a word boundary
            tags = [
                (256, _LONG, 1, width),                        # ImageWidth
                (257, _LONG, 1, height),                       # ImageLength
                (258, _SHORT, samples, extra_at if samples == 3 else 8 * page.itemsize),
                (259, _SHORT, 1, _NONE),                       # Compression
                (262, _SHORT, 1, 2 if samples == 3 else 1),    # Photometric: RGB / BlackIsZero
                (273, _LONG, 1, pixels_at),                    # StripOffsets
                (277, _SHORT, 1, samples),                     # SamplesPerPixel
                (278, _LONG, 1, height),                       # RowsPerStrip
                (279, _LONG, 1, page.nbytes),                  # StripByteCounts
                (339, _SHORT, 1, _SAMPLE_FORMATS[page.dtype]),  # SampleFormat
            ]
            fid.write(struct.pack("<H", n_tags))
            for tag, kind, count, value in tags:
                if kind == _SHORT and count == 1:  # in the value field's first two bytes
                    fid.write(struct.pack("<HHIHH", tag, kind, count, value, 0))
                else:
                    fid.write(struct.pack("<HHII", tag, kind, count, value))
            fid.write(struct.pack("<I", next_at if index + 1 < len(pages) else 0))
            fid.write(bits)
            fid.write(page.tobytes())
            fid.write(b"\0" * (next_at - pixels_at - page.nbytes))


def read_tags(path: str) -> dict:
    """``{tag: value}`` of the first IFD of a little-endian TIFF, for the
    tags that hold one value (no image data is decoded)."""
    with open(path, "rb") as fid:
        first = _read_ifds(fid, path)[0]
    return {tag: value[0] for tag, value in first.items() if value is not None and len(value) == 1}


def find_scene_file(base: str) -> str:
    """``base`` if it exists, else a ``.npy`` beside it (its extension
    replaced, then appended), as the JAX package resolves scene files."""
    if os.path.exists(base):
        return base
    root, _ = os.path.splitext(base)
    for candidate in (root + ".npy", base + ".npy"):
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(base)


def read_bmp(path: str) -> np.ndarray:
    """An uncompressed 1-, 8- or 24-bit BMP as ``imageio.v2.imread`` returns it.

    A palette image whose palette is the grey ramp comes back as its indices:
    ``bool`` for 1 bit (black, white), ``uint8`` for 8 bits; any other
    palette is looked up into ``H x W x 3`` RGB, as is a 24-bit image.
    """
    with open(path, "rb") as fid:
        data = fid.read()
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{path}: not a BMP")
    pixels_at, header_size = struct.unpack_from("<II", data, 10)
    if header_size < 40:
        raise ValueError(f"{path}: BMP header of {header_size} bytes (OS/2) is not read")
    width, height, _, bits, compression, _, _, _, colors = struct.unpack_from(
        "<iiHHIIiiI", data, 18)
    if compression != 0:
        raise ValueError(f"{path}: BMP compression {compression} is not read, only 0 (none)")
    if bits not in (1, 8, 24):
        raise ValueError(f"{path}: {bits}-bit BMP is not read, only 1, 8 and 24 bits")
    rows = abs(height)
    stride = (width * bits + 31) // 32 * 4
    raw = np.frombuffer(data, dtype=np.uint8, count=rows * stride, offset=pixels_at)
    raw = raw.reshape(rows, stride)
    if height > 0:
        raw = raw[::-1]  # rows are stored bottom-up
    if bits == 24:
        return np.ascontiguousarray(raw[:, :width * 3].reshape(rows, width, 3)[:, :, ::-1])
    colors = colors or 1 << bits
    palette = np.frombuffer(data, dtype=np.uint8, count=4 * colors,
                            offset=14 + header_size).reshape(colors, 4)[:, 2::-1]
    if bits == 1:
        index = np.unpackbits(raw, axis=1)[:, :width]
        grey = np.array([0, 255])[:colors]
    else:
        index = raw[:, :width]
        grey = np.arange(colors)
    if np.array_equal(palette, np.repeat(grey[:, None], 3, axis=1)):
        return index.astype(bool) if bits == 1 else np.ascontiguousarray(index)
    return palette[index]


def write_bmp(path: str, mask: np.ndarray) -> None:
    """Write a 2-D ``bool`` mask as an uncompressed 1-bit BMP (black, white)."""
    if mask.dtype != bool or mask.ndim != 2:
        raise ValueError(f"write_bmp writes a 2-D bool mask, got {mask.dtype} {mask.shape}")
    height, width = mask.shape
    stride = (width + 31) // 32 * 4
    rows = np.zeros((height, stride), dtype=np.uint8)
    packed = np.packbits(mask[::-1], axis=1)
    rows[:, :packed.shape[1]] = packed
    pixels_at = 14 + 40 + 8
    with open(path, "wb") as fid:
        fid.write(b"BM" + struct.pack("<IHHI", pixels_at + rows.nbytes, 0, 0, pixels_at))
        fid.write(struct.pack("<IiiHHIIiiII", 40, width, height, 1, 1, 0, rows.nbytes,
                              2835, 2835, 2, 2))
        fid.write(bytes([0, 0, 0, 0, 255, 255, 255, 0]))
        fid.write(rows.tobytes())
