"""The port's own copies of the OpenCV calls the JAX utilities make.

The JAX package's ``utils/lidar_matcher.py`` and
``utils/reveal_shadow_targets.py`` call OpenCV (``cv2``), which the card's
machine does not have. Each function here computes what its OpenCV call
returns; the tests hold each against ``cv2`` (5.0) where it is installed.
Host work is numpy; the arithmetic over a scene (the template match) is
torch on the caller's device.

- :func:`resize_area`: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  for an enlargement, where OpenCV interpolates linearly with its area
  weights (it averages areas only when it shrinks);
- :func:`match_template_ccorr_normed` and :func:`max_location`:
  ``cv2.matchTemplate(image, templ, TM_CCORR_NORMED)`` and the maximum's
  location of ``cv2.minMaxLoc``;
- :func:`find_contours`: ``cv2.findContours(img, RETR_LIST,
  CHAIN_APPROX_NONE)`` by Suzuki-Abe border following, the same contours with
  the same points in the same order;
- :func:`fill_contour`: the mask of ``cv2.drawContours(mask, [c], 0, 255, -1)``;
- :func:`draw_rectangle`: ``cv2.rectangle`` with a thick line, burnt into an
  array.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _area_enlarge_weights(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source index and float32 weight of the second source pixel, for each
    destination pixel of one axis (OpenCV's ``resize`` in area mode when
    ``dst >= src``): ``sx = floor(dx * scale)`` and ``f = (dx + 1) - (sx + 1) /
    scale``, 0 when ``f <= 0`` and else its fraction, with both clamped at the
    border."""
    inv_scale = dst / src  # OpenCV's inv_scale_x: dsize over ssize, in double
    scale = 1.0 / inv_scale
    dx = np.arange(dst, dtype=np.float64)
    sx = np.floor(dx * scale).astype(np.int64)
    f = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    high = sx >= src - 1
    sx = np.where(high, src - 1, np.maximum(sx, 0))
    f = np.where(high | (sx < 0), np.float32(0), f).astype(np.float32)
    return sx, f


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` of a 2-D float32
    image to ``size = (width, height)``, for an enlargement on both axes.

    OpenCV weights each output pixel by its two nearest source pixels on
    each axis, rows after columns, in float32. Shrinking (true area
    averaging) is not what the utilities do, so it raises.
    """
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError(f"resize_area takes a 2-D image, got shape {img.shape}")
    width, height = int(size[0]), int(size[1])
    src_h, src_w = img.shape
    if width < src_w or height < src_h:
        raise ValueError(f"resize_area only enlarges: {img.shape} -> ({height}, {width})")
    sx, fx = _area_enlarge_weights(src_w, width)
    sy, fy = _area_enlarge_weights(src_h, height)
    sx1 = np.minimum(sx + 1, src_w - 1)
    sy1 = np.minimum(sy + 1, src_h - 1)
    one = np.float32(1)
    rows = img[:, sx] * (one - fx) + img[:, sx1] * fx
    return (rows[sy] * (one - fy)[:, None] + rows[sy1] * fy[:, None]).astype(np.float32)


def _fft_size(n: int) -> int:
    """The least 2^a 3^b 5^c 7^d at or above ``n``: a length the FFT is fast at."""
    best = 1 << max(0, (n - 1).bit_length())
    p7 = 1
    while p7 < best:
        p5 = p7
        while p5 < best:
            p3 = p5
            while p3 < best:
                p2 = p3
                while p2 < n:
                    p2 *= 2
                best = min(best, p2)
                p3 *= 3
            p5 *= 5
        p7 *= 7
    return best


def match_template_ccorr_normed(image: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """``cv2.matchTemplate(image, templ, cv2.TM_CCORR_NORMED)`` in float64 on
    the tensors' device: ``R[y, x] = sum(T * I[y:y+h, x:x+w]) /
    sqrt(sum(T^2) * sum(I[y:y+h, x:x+w]^2))`` over the ``(H-h+1, W-w+1)``
    positions.

    The cross-correlation is one FFT product in float64 (a real-size match
    is ~8e11 multiply-adds directly, and on a nearly flat surface float32
    sums move the maximum); the window sums of squares come from a summed-area
    table. As OpenCV does, a ratio at or above 1 but under 1.125 is 1 and one
    further off (or a zero denominator) is 0.
    """
    if image.dim() != 2 or templ.dim() != 2:
        raise ValueError("match_template_ccorr_normed takes 2-D image and template")
    image = image.to(torch.float64)
    templ = templ.to(device=image.device, dtype=torch.float64)
    big_h, big_w = image.shape
    h, w = templ.shape
    if h > big_h or w > big_w:
        raise ValueError(f"template {tuple(templ.shape)} larger than image {tuple(image.shape)}")
    out_h, out_w = big_h - h + 1, big_w - w + 1
    # circular correlation at a size >= the image: the valid positions never wrap
    fft_h, fft_w = _fft_size(big_h), _fft_size(big_w)
    spectrum = torch.fft.rfft2(image, s=(fft_h, fft_w))
    spectrum *= torch.fft.rfft2(templ, s=(fft_h, fft_w)).conj()
    corr = torch.fft.irfft2(spectrum, s=(fft_h, fft_w))[:out_h, :out_w]
    del spectrum
    table = torch.zeros((big_h + 1, big_w + 1), dtype=torch.float64, device=image.device)
    table[1:, 1:] = (image * image).cumsum(0).cumsum(1)
    window = (table[h:h + out_h, w:w + out_w] - table[:out_h, w:w + out_w]
              - table[h:h + out_h, :out_w] + table[:out_h, :out_w])
    norm = window.clamp_min(0).sqrt() * (templ * templ).sum().sqrt()
    ratio = corr / norm
    inside = corr.abs() < norm
    near = ~inside & (corr.abs() < norm * 1.125)
    ones = torch.where(corr > 0, 1.0, -1.0).to(torch.float64)
    return torch.where(inside, ratio, torch.where(near, ones, torch.zeros_like(ratio)))


def max_location(result: torch.Tensor) -> Tuple[int, int]:
    """``(x, y)`` of the maximum of a 2-D map, the first in row-major order on
    a tie, as ``cv2.minMaxLoc``'s ``max_loc``."""
    flat = result.reshape(-1)
    first = torch.nonzero(flat == flat.max())[0, 0]
    y, x = divmod(int(first), result.shape[1])
    return x, y


# Suzuki-Abe chain codes (OpenCV's order): 0 is +x, counted counter-clockwise
# on the screen (y grows downwards)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BORDER = -126  # OpenCV's ``nbd | -128`` as a signed byte, nbd = 2
_VISITED = 2


def _follow_border(img: np.ndarray, y0: int, x0: int, is_hole: bool) -> List[Tuple[int, int]]:
    """One border from the pixel ``(y0, x0)`` of the zero-padded marked image
    (OpenCV's ``icvFetchContour`` with ``CHAIN_APPROX_NONE``): the points in
    padded coordinates, marking each border pixel as it goes."""
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        y1, x1 = y0 + _CODE_DY[s], x0 + _CODE_DX[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end and img[y1, x1] == 0:  # a single pixel
        img[y0, x0] = _RIGHT_BORDER
        return [(x0, y0)]
    points = []
    y3, x3 = y0, x0
    px, py = x0, y0
    while True:
        s_end = s
        while True:
            s += 1
            y4, x4 = y3 + _CODE_DY[s & 7], x3 + _CODE_DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:  # the right neighbour was examined and is 0
            img[y3, x3] = _RIGHT_BORDER
        elif img[y3, x3] == 1:
            img[y3, x3] = _VISITED
        points.append((px, py))
        px += _CODE_DX[s]
        py += _CODE_DY[s]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def find_contours(binary: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)[0]``,
    each contour as an int32 ``[N, 2]`` array of ``(x, y)`` points.

    Any non-zero pixel is foreground, 8-connected; the outside of the image
    is 0. Borders are found in raster order (an outer border where a 0 is
    followed by an unvisited 1, a hole's where a foreground pixel not marked
    as a right border is followed by a 0) and followed clockwise from their
    start; every step adds the current point, so a one-pixel-wide part
    repeats its points. OpenCV 5.0 returns them in the reverse of that order,
    each hole before the border that encloses it; so does this.
    """
    binary = np.asarray(binary)
    if binary.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D image, got shape {binary.shape}")
    img = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), dtype=np.int16)
    img[1:-1, 1:-1] = binary != 0
    # zero-ness never changes while borders are marked, so the only places
    # where a border can start are where it changes along a row
    fg = img != 0
    candidates = np.argwhere(fg[:, 1:] != fg[:, :-1])
    contours = []
    for y, xm1 in candidates:
        x = xm1 + 1
        prev, p = img[y, x - 1], img[y, x]
        if prev == 0 and p == 1:
            points = _follow_border(img, y, x, False)
        elif p == 0 and prev >= 1:
            points = _follow_border(img, y, x - 1, True)
        else:
            continue
        contours.append(np.asarray(points, dtype=np.int32).reshape(-1, 2) - 1)
    return contours[::-1]


def fill_contour(shape: Sequence[int], contour: np.ndarray) -> np.ndarray:
    """The boolean mask of ``cv2.drawContours(zeros(shape), [contour], 0, 255,
    -1) == 255``: the contour's points, and between them the scanline spans
    of OpenCV's even-odd polygon fill.

    For a contour from :func:`find_contours` every edge is one step, so each
    edge that moves in y covers exactly one scanline, at its upper end's x;
    on each scanline the sorted edge x's pair up into filled spans.
    """
    height, width = int(shape[0]), int(shape[1])
    mask = np.zeros((height, width), dtype=bool)
    pts = np.asarray(contour, dtype=np.int64).reshape(-1, 2)
    if pts.shape[0] == 0:
        return mask
    prev = np.roll(pts, 1, axis=0)
    steps = np.abs(pts - prev).max(axis=1)
    if steps.max() > 1:
        raise ValueError("fill_contour takes contours whose points are 8-neighbours, "
                         "as find_contours returns them")
    inside = (pts[:, 0] >= 0) & (pts[:, 0] < width) & (pts[:, 1] >= 0) & (pts[:, 1] < height)
    mask[pts[inside, 1], pts[inside, 0]] = True
    moving = prev[:, 1] != pts[:, 1]
    if np.count_nonzero(moving) < 2:
        return mask
    upper = np.where((prev[:, 1] < pts[:, 1])[:, None], prev, pts)[moving]
    order = np.lexsort((upper[:, 0], upper[:, 1]))
    upper = upper[order]
    rows, starts = np.unique(upper[:, 1], return_index=True)
    for y, lo, hi in zip(rows, starts, np.append(starts[1:], upper.shape[0])):
        if not 0 <= y < height:
            continue
        xs = upper[lo:hi, 0]
        for a, b in zip(xs[0::2], xs[1::2]):
            a, b = max(int(a), 0), min(int(b), width - 1)
            if a <= b:
                mask[y, a:b + 1] = True
    return mask


def draw_rectangle(img: np.ndarray, top_left: Tuple[int, int], bottom_right: Tuple[int, int],
                   value, thickness: int) -> np.ndarray:
    """``cv2.rectangle(img, top_left, bottom_right, value, thickness)`` for a
    thick line, in place: every pixel within ``thickness / 2`` of one of the
    rectangle's four sides (OpenCV draws each side as a band with round
    ends)."""
    (x0, y0), (x1, y1) = top_left, bottom_right
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    radius = thickness / 2.0
    ys, xs = np.ogrid[:img.shape[0], :img.shape[1]]
    # distance to the nearest point of each side, as a segment
    dx = np.maximum(np.maximum(x0 - xs, xs - x1), 0)
    dy = np.maximum(np.maximum(y0 - ys, ys - y1), 0)
    near_vertical = np.minimum(np.abs(xs - x0), np.abs(xs - x1)) ** 2 + dy ** 2
    near_horizontal = np.minimum(np.abs(ys - y0), np.abs(ys - y1)) ** 2 + dx ** 2
    img[np.minimum(near_vertical, near_horizontal) <= radius * radius] = value
    return img
