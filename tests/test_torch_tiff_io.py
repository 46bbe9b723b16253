"""The port's numpy TIFF and BMP I/O against PIL and imageio, which the JAX
package reads through: ``imread`` on files PIL writes (every compression,
predictor, sample type and page count), ``imwrite`` band stacks read back by
the JAX ``imread``, ``read_bmp`` against ``imageio.v2.imread``, and the
files the reader refuses."""

import struct

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from hypelcnn_tpu.utils.tiff_io import find_scene_file as jax_find_scene_file
from hypelcnn_tpu.utils.tiff_io import imread as jax_imread
from hypelcnn_tpu.utils.tiff_io import imwrite as jax_imwrite
from hypelcnn_tpu_torch.utils.tiff_io import (
    find_scene_file,
    imread,
    imwrite,
    read_bmp,
    read_tags,
    write_bmp,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (PIL's name, TIFF Compression tag)
COMPRESSIONS = [("raw", 1), ("tiff_lzw", 5), ("tiff_deflate", 32946),
                ("tiff_adobe_deflate", 8), ("packbits", 32773)]
# PIL writes int16 arrays as int32; the port's writer makes the int16 files
DTYPES = [np.uint8, np.uint16, np.int32, np.float32]


def _equal(ours, theirs):
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def _scene(rng, shape, dtype):
    if dtype == np.float32:
        return rng.normal(0, 900, shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -40000), min(info.max, 70000), shape).astype(dtype)


def _patch_tags(path, values=(), relabel=()):
    """Rewrite a little-endian TIFF's tags in place, in every IFD: ``values``
    maps a SHORT tag to its new value, ``relabel`` a tag to a new number."""
    data = bytearray(open(path, "rb").read())
    (offset,) = struct.unpack_from("<I", data, 4)
    while offset:
        (count,) = struct.unpack_from("<H", data, offset)
        for at in range(offset + 2, offset + 2 + 12 * count, 12):
            tag = struct.unpack_from("<H", data, at)[0]
            if tag in dict(values):
                struct.pack_into("<H", data, at + 8, dict(values)[tag])
            if tag in dict(relabel):
                struct.pack_into("<H", data, at, dict(relabel)[tag])
        (offset,) = struct.unpack_from("<I", data, offset + 2 + 12 * count)
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("compression, tag", COMPRESSIONS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("pages", [1, 3])
def test_imread_matches_pil(tmp_path, compression, tag, dtype, predictor, pages):
    """Strips of 64 rows, the last one short. PIL writes Deflate as tag 8,
    which is relabelled 32946 (the same codec) for that case."""
    rng = np.random.default_rng(pages * 10 + predictor)
    stack = _scene(rng, (150, 37, pages), dtype)
    images = [Image.fromarray(np.ascontiguousarray(stack[:, :, i])) for i in range(pages)]
    path = tmp_path / "scene.tif"
    info = {278: 64, 317: predictor} if predictor == 2 else {278: 64}
    images[0].save(path, compression=compression, save_all=True, append_images=images[1:],
                   tiffinfo=info)
    if tag == 32946:
        _patch_tags(path, values={259: 32946})
    with Image.open(path) as im:
        assert im.tag_v2[259] == tag and len(im.tag_v2[273]) == 3
    _equal(imread(str(path)), jax_imread(str(path)))
    _equal(imread(str(path)), stack[:, :, 0] if pages == 1 else stack)


@pytest.mark.parametrize("compression", [name for name, _ in COMPRESSIONS])
def test_imread_reads_rgb_pages_as_pil(tmp_path, compression):
    rgb = np.random.default_rng(3).integers(0, 256, (41, 29, 3)).astype(np.uint8)
    path = tmp_path / "rgb.tif"
    Image.fromarray(rgb).save(path, compression=compression)
    _equal(imread(str(path)), jax_imread(str(path)))
    _equal(imread(str(path)), rgb)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32, np.float32])
@pytest.mark.parametrize("shape", [(23, 19), (23, 19, 1), (23, 19, 5), (7, 9, 3), (7, 9, 4)])
def test_imwrite_is_read_back_by_the_jax_imread(tmp_path, dtype, shape):
    """Band stacks go one uncompressed page a band; a uint8 ``H x W x 3`` is
    one RGB page; int16 comes back as int32 from both readers, as PIL gives it."""
    data = _scene(np.random.default_rng(len(shape)), shape, dtype)
    path = str(tmp_path / "w.tif")
    imwrite(path, data)
    expected = data[:, :, 0] if shape[-1:] == (1,) else data
    if dtype == np.int16:
        expected = expected.astype(np.int32)
    _equal(jax_imread(path), expected)
    _equal(imread(path), expected)
    assert read_tags(path)[259] == 1
    if data.ndim == 3 and not (dtype == np.uint8 and shape[2] == 3):
        with Image.open(path) as im:
            assert im.n_frames == shape[2]


def test_the_readers_agree_on_the_jax_writers_files(tmp_path):
    rng = np.random.default_rng(4)
    for name, data in (("stack", _scene(rng, (12, 8, 6), np.uint16)),
                       ("lidar", _scene(rng, (12, 8), np.float32)),
                       ("gt", _scene(rng, (12, 8), np.uint8)),
                       ("rgb", _scene(rng, (12, 8, 3), np.uint8))):
        path = str(tmp_path / f"{name}.tif")
        jax_imwrite(path, data)
        _equal(imread(path), jax_imread(path))
    imwrite(str(tmp_path / "a.npy"), data)
    _equal(imread(str(tmp_path / "a.npy")), data)


def test_find_scene_file_matches_jax(tmp_path):
    (tmp_path / "scene.npy").write_bytes(b"")
    (tmp_path / "other.tif.npy").write_bytes(b"")
    (tmp_path / "real.tif").write_bytes(b"")
    for name in ("scene.tif", "other.tif", "real.tif"):
        assert find_scene_file(str(tmp_path / name)) == jax_find_scene_file(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        find_scene_file(str(tmp_path / "missing.tif"))


@pytest.mark.parametrize("kind", ["1-bit", "8-bit grey", "8-bit palette", "24-bit",
                                  "1-bit palette", "8-bit short palette"])
@pytest.mark.parametrize("width", [1, 10, 33])
def test_read_bmp_matches_imageio(tmp_path, kind, width):
    rng = np.random.default_rng(width)
    shape = (13, width)
    path = tmp_path / "m.bmp"
    if kind == "1-bit":
        Image.fromarray(rng.random(shape) < 0.4).save(path)
    elif kind == "8-bit grey":
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(path)
    elif kind == "24-bit":
        Image.fromarray(rng.integers(0, 256, shape + (3,)).astype(np.uint8)).save(path)
    else:
        colors = {"8-bit palette": 256, "1-bit palette": 2, "8-bit short palette": 5}[kind]
        image = Image.fromarray(rng.integers(0, colors, shape).astype(np.uint8), mode="P")
        image.putpalette(rng.integers(0, 256, 3 * colors).astype(np.uint8).tobytes())
        image.save(path, bits=1 if colors == 2 else 8)
    _equal(read_bmp(str(path)), imageio.imread(path))


def test_write_bmp_is_read_by_imageio_as_a_bool_mask(tmp_path):
    mask = np.random.default_rng(0).random((17, 35)) < 0.3
    path = str(tmp_path / "mask.bmp")
    write_bmp(path, mask)
    _equal(imageio.imread(path), mask)
    _equal(read_bmp(path), mask)
    with pytest.raises(ValueError):
        write_bmp(path, mask.astype(np.uint8))


@pytest.mark.parametrize("changes, name", [
    ({259: 7}, "Compression"),            # JPEG
    ({259: 2}, "Compression"),            # CCITT
    ({258: 12}, "BitsPerSample"),
    ({339: 3}, "BitsPerSample"),          # 8-bit float
    ({262: 3}, "PhotometricInterpretation"),  # palette
    ({262: 0}, "PhotometricInterpretation"),  # WhiteIsZero
    ({277: 4}, "SamplesPerPixel"),
    ({"relabel": 256}, "TileWidth"),      # ImageWidth relabelled TileWidth
])
def test_imread_refuses_what_it_does_not_read(tmp_path, changes, name):
    """A one-page uint8 TIFF of the port's writer with one tag changed."""
    path = str(tmp_path / "t.tif")
    imwrite(path, np.zeros((4, 5), dtype=np.uint8))
    if "relabel" in changes:
        _patch_tags(path, relabel={changes["relabel"]: 322})
    else:
        _patch_tags(path, values=changes)
    with pytest.raises(ValueError, match=name) as info:
        imread(path)
    assert path in str(info.value)


def test_imread_refuses_big_endian_and_bmp_refuses_other_depths(tmp_path):
    path = tmp_path / "big.tif"
    path.write_bytes(b"MM\0*\0\0\0\x08" + bytes(16))
    with pytest.raises(ValueError, match="big-endian") as info:
        imread(str(path))
    assert str(path) in str(info.value)
    bmp = tmp_path / "rgba.bmp"
    Image.fromarray(np.zeros((3, 4, 4), dtype=np.uint8)).save(bmp)
    with pytest.raises(ValueError, match="32-bit"):
        read_bmp(str(bmp))
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / "f.tif"), np.zeros((3, 4), dtype=np.float64))
