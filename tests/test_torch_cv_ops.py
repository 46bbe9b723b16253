"""The port's copies of OpenCV's calls (``hypelcnn_tpu_torch/utils/cv_ops.py``)
against OpenCV itself: the area resize, the normalized template match and
its maximum, and the contours and their fills, which must equal OpenCV's
exactly (list, order, points and masks)."""

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.utils.cv_ops import (
    draw_rectangle,
    fill_contour,
    find_contours,
    match_template_ccorr_normed,
    max_location,
    resize_area,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("shape, scale", [((7, 9), 5), ((13, 31), 2.0), ((40, 17), 2.0),
                                          ((1, 5), 5), ((11, 12), 2.5), ((349 // 10, 64), 5)])
def test_resize_area_enlarges_as_opencv(shape, scale):
    img = np.random.default_rng(shape[0]).uniform(0, 1000, shape).astype(np.float32)
    size = (int(shape[1] * scale), int(shape[0] * scale))
    want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    got = resize_area(img, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_resize_area_refuses_to_shrink():
    with pytest.raises(ValueError, match="only enlarges"):
        resize_area(np.zeros((10, 10), np.float32), (5, 20))


def _direct_ccorr_normed(image: np.ndarray, templ: np.ndarray) -> np.ndarray:
    image, templ = image.astype(np.float64), templ.astype(np.float64)
    h, w = templ.shape
    out = np.empty((image.shape[0] - h + 1, image.shape[1] - w + 1))
    for y in range(out.shape[0]):
        for x in range(out.shape[1]):
            window = image[y:y + h, x:x + w]
            out[y, x] = (window * templ).sum() / np.sqrt((window ** 2).sum() * (templ ** 2).sum())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_match_template_agrees_with_opencv_and_a_direct_sum(seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (48, 70)).astype(np.float32)
    y0, x0 = rng.integers(0, 20, size=2)
    templ = image[y0:y0 + 25, x0:x0 + 40] + rng.normal(0, 0.2, (25, 40)).astype(np.float32)
    got = match_template_ccorr_normed(torch.from_numpy(image), torch.from_numpy(templ)).numpy()
    want = cv2.matchTemplate(image, templ, cv2.TM_CCORR_NORMED)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _direct_ccorr_normed(image, templ), rtol=0, atol=1e-12)
    top_two = np.sort(got.reshape(-1))[-2:]
    if top_two[1] - top_two[0] > 1e-6:
        assert max_location(torch.from_numpy(got)) == cv2.minMaxLoc(want)[3] == (x0, y0)


def test_max_location_takes_the_first_maximum_in_row_major_order():
    surface = torch.zeros((4, 5), dtype=torch.float64)
    surface[2, 1] = surface[1, 3] = surface[3, 0] = 1.0
    assert max_location(surface) == (3, 1)
    assert cv2.minMaxLoc(surface.numpy())[3] == (3, 1)


def test_match_template_is_zero_where_opencv_gives_up():
    """A zero window has no correlation: OpenCV writes 0 there."""
    image = np.zeros((10, 12), np.float32)
    image[:, 6:] = 1.0
    templ = np.ones((3, 3), np.float32)
    got = match_template_ccorr_normed(torch.from_numpy(image), torch.from_numpy(templ)).numpy()
    want = cv2.matchTemplate(image, templ, cv2.TM_CCORR_NORMED)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, :4] == 0).all()


def _binary_map(seed: int) -> np.ndarray:
    """Random maps from 1 x 1 to 40 x 40: speckle at densities 0.1 to 0.9,
    blocks touching the edges, and rings with nested islands."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 41, size=2))
    density = rng.uniform(0.1, 0.9)
    kind = seed % 4
    if kind == 0:
        return (rng.random((h, w)) < density).astype(np.uint8)
    if kind == 1:
        block = int(rng.integers(2, 6))
        coarse = rng.random((-(-h // block), -(-w // block))) < density
        return np.kron(coarse, np.ones((block, block), np.uint8))[:h, :w].astype(np.uint8)
    img = (rng.random((h, w)) < density * 0.3).astype(np.uint8)
    for _ in range(int(rng.integers(1, 4))):  # rings, each with an island in its hole
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(2, 9))
        yy, xx = np.ogrid[:h, :w]
        dist = np.maximum(np.abs(yy - cy), np.abs(xx - cx))
        img[(dist <= r) & (dist >= r - 1)] = 1
        img[(dist <= r - 2) & (dist >= 1)] = 0
        img[dist <= max(0, r - 4)] = 1
    if kind == 3:
        img[rng.random((h, w)) < 0.05] ^= 1  # one-pixel shapes and holes
    return img


@pytest.mark.parametrize("block", range(4))
def test_contours_and_fills_equal_opencv_exactly(block):
    """200 maps in 4 cases: the same contours in the same order with the
    same points (repeats kept), and each contour's fill the same mask."""
    counts = 0
    for seed in range(block * 50, block * 50 + 50):
        img = _binary_map(seed)
        want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
        got = find_contours(img)
        assert len(got) == len(want), seed
        for g, c in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, c.reshape(-1, 2), err_msg=f"seed {seed}")
            mask = cv2.drawContours(np.zeros(img.shape, np.uint8), [c], 0, 255, -1) == 255
            np.testing.assert_array_equal(fill_contour(img.shape, g), mask,
                                          err_msg=f"seed {seed}")
        counts += len(want)
    assert counts > 100


def test_contours_of_edge_cases():
    for img in (np.ones((1, 1), np.uint8), np.zeros((3, 4), np.uint8),
                np.ones((5, 7), np.uint8), np.eye(6, dtype=np.uint8),
                np.pad(np.ones((3, 3), np.uint8), 2)):
        want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
        got = find_contours(img)
        assert [g.tolist() for g in got] == [c.reshape(-1, 2).tolist() for c in want]


def test_rectangle_burns_a_thick_frame_close_to_opencv():
    img = np.zeros((120, 200), np.uint8)
    want = cv2.rectangle(img.copy(), (30, 20), (150, 90), 255, 20)
    got = draw_rectangle(img.copy(), (30, 20), (150, 90), 255, 20)
    # the frame's bands agree; OpenCV's round corners differ by a few pixels
    assert (got == want).mean() > 0.995
    assert got[55, 30] == 255 and got[55, 90] == 0 and got[20, 100] == 255
