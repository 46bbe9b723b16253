"""HSI -> sRGB rendering by CIE colorimetric integration
(``hypelcnn_tpu/utils/hsi_rgb.py``, copied: numpy only).

The bands nearest 400-700 nm in 10 nm steps are integrated against the CIE
1931 2-degree standard-observer color matching functions under illuminant
E, then XYZ goes to sRGB.
"""

from __future__ import annotations

import numpy as np

# CIE 1931 2-degree standard observer CMFs, 400..700 nm in 10 nm steps
# (public colorimetric data, 31 samples)
_CIE1931_CMF = np.array([
    # x_bar,  y_bar,  z_bar
    [0.014310, 0.000396, 0.067850],  # 400
    [0.043510, 0.001210, 0.207400],  # 410
    [0.134380, 0.004000, 0.645600],  # 420
    [0.283900, 0.011600, 1.385600],  # 430
    [0.348280, 0.023000, 1.747060],  # 440
    [0.336200, 0.038000, 1.772110],  # 450
    [0.290800, 0.060000, 1.669200],  # 460
    [0.195360, 0.090980, 1.287640],  # 470
    [0.095640, 0.139020, 0.812950],  # 480
    [0.032010, 0.208020, 0.465180],  # 490
    [0.004900, 0.323000, 0.272000],  # 500
    [0.009300, 0.503000, 0.158200],  # 510
    [0.063270, 0.710000, 0.078250],  # 520
    [0.165500, 0.862000, 0.042160],  # 530
    [0.290400, 0.954000, 0.020300],  # 540
    [0.433450, 0.994950, 0.008750],  # 550
    [0.594500, 0.995000, 0.003900],  # 560
    [0.762100, 0.952000, 0.002100],  # 570
    [0.916300, 0.870000, 0.001650],  # 580
    [1.026300, 0.757000, 0.001100],  # 590
    [1.062200, 0.631000, 0.000800],  # 600
    [1.002600, 0.503000, 0.000340],  # 610
    [0.854450, 0.381000, 0.000190],  # 620
    [0.642400, 0.265000, 0.000050],  # 630
    [0.447900, 0.175000, 0.000020],  # 640
    [0.283500, 0.107000, 0.000000],  # 650
    [0.164900, 0.061000, 0.000000],  # 660
    [0.087400, 0.032000, 0.000000],  # 670
    [0.046770, 0.017000, 0.000000],  # 680
    [0.022700, 0.008210, 0.000000],  # 690
    [0.011359, 0.004102, 0.000000],  # 700
], dtype=np.float64)

_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float64)


def _spectral2xyz_img_vectorized(cmfs: np.ndarray, r: np.ndarray) -> np.ndarray:
    """[N, 31] reflectances -> [N, 3] XYZ (illuminant E, dw = 10 nm)."""
    x_bar, y_bar, z_bar = cmfs[:, 0], cmfs[:, 1], cmfs[:, 2]
    s = np.ones_like(y_bar)  # illuminant E: constant spectrum (normalized)
    dw = 10.0
    k = 100.0 / (np.sum(y_bar * s) * dw)
    xyz = k * np.stack([np.sum(r * x_bar * s * dw, axis=-1),
                        np.sum(r * y_bar * s * dw, axis=-1),
                        np.sum(r * z_bar * s * dw, axis=-1)], axis=-1)
    return xyz


def _xyz2srgb(xyz: np.ndarray) -> np.ndarray:
    """Linear XYZ (0..1 scale) -> gamma-encoded sRGB in [0, 1]."""
    rgb_lin = xyz @ _XYZ_TO_SRGB.T
    rgb_lin = np.clip(rgb_lin, 0.0, 1.0)
    return np.where(rgb_lin <= 0.0031308,
                    12.92 * rgb_lin,
                    1.055 * np.power(rgb_lin, 1.0 / 2.4) - 0.055)


def get_rgb_from_hsi(band_measurements: np.ndarray, casi_normalized: np.ndarray
                     ) -> np.ndarray:
    """[H, W, bands] normalized HSI -> [H, W, 3] sRGB float in [0, 1]."""
    wi = np.round(band_measurements)
    visual_spec = list(range(400, 701, 10))
    x_cor = [int(np.argmin(np.abs(wi - nm))) for nm in visual_spec]
    spectral = casi_normalized[:, :, x_cor]
    h, w, c = spectral.shape
    xyz = _spectral2xyz_img_vectorized(_CIE1931_CMF, spectral.reshape(-1, c))
    return _xyz2srgb(xyz / 100.0).reshape(h, w, 3)
