"""Depth-sensor models: RGBD (dense), USS (cone minimum), ToF (8x8 zones).

Frozen copy of ``virus_nerf_tpu_torch/data/sensors.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Host-side numpy preprocessing + device-side masks, counterpart of
reference: datasets/sensor_base.py:7-63, datasets/sensor_uss.py:9-239,
datasets/sensor_tof.py:9-148, datasets/sensor_rgbd.py:7-33.

Each model converts raw depth into a per-camera-pixel depth image with NaN
for unknown pixels, and exposes a boolean field-of-view ``mask`` (H*W,) used
by the ``valid_uss`` / ``valid_tof`` sampling strategies.

Copied unchanged from ``virus_nerf_tpu/data/sensors.py``: the module is
numpy only, but importing it from the JAX package runs
``virus_nerf_tpu/data/__init__.py``, which imports jax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    from scipy.ndimage import grey_dilation

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


class SensorModel:
    """Base: angle-of-view geometry helpers
    (reference: datasets/sensor_base.py:21-63)."""

    def __init__(self, img_wh, camera_aov_deg):
        self.W, self.H = img_wh
        self.camera_aov = np.asarray(camera_aov_deg, np.float64)  # (w, h) deg

    def aov2pixel(self, aov_sensor_deg):
        """Sensor angle-of-view -> extent in pixels relative to the camera
        AoV (reference: datasets/sensor_base.py:47-63)."""
        img_wh = np.array([self.W, self.H], np.float64)
        num = img_wh * np.asarray(aov_sensor_deg, np.float64) / self.camera_aov
        return np.round(num).astype(int)

    def pos2idx(self, pos_h, pos_w):
        ih = np.clip(np.round(pos_h).astype(int), 0, self.H - 1)
        iw = np.clip(np.round(pos_w).astype(int), 0, self.W - 1)
        return ih, iw

    def convert_depth(self, depths, format="img"):
        raise NotImplementedError


class RGBDModel(SensorModel):
    """Dense depth: identity conversion (reference: sensor_rgbd.py:20-33)."""

    def __init__(self, img_wh, camera_aov_deg):
        super().__init__(img_wh, camera_aov_deg)
        self.mask = np.ones(self.H * self.W, bool)

    def convert_depth(self, depths, format="img"):
        return np.copy(depths)


class USSModel(SensorModel):
    """Ultrasonic sensor: one wide-cone minimum-range reading broadcast over
    an elliptical FoV mask (reference: sensor_uss.py:84-111,219-239)."""

    def __init__(self, img_wh, camera_aov_deg, aov_sensor_deg=(55.0, 35.0)):
        super().__init__(img_wh, camera_aov_deg)
        self.aov_sensor = aov_sensor_deg
        self.mask = self._create_mask()

    def _create_mask(self) -> np.ndarray:
        # elliptical cone footprint centered in the image
        # (reference: sensor_uss.py:219-239)
        pix_wh = (self.aov2pixel(self.aov_sensor) / 2.0).astype(np.int32)
        m1, m2 = np.meshgrid(np.arange(self.H), np.arange(self.W), indexing="ij")
        m1 = m1 - self.H / 2
        m2 = m2 - self.W / 2
        mask = (m1 / pix_wh[1]) ** 2 + (m2 / pix_wh[0]) ** 2 < 1
        return mask.flatten()

    def convert_depth(self, depths, format="img"):
        """Broadcast the cone-minimum depth over the FoV mask; everything
        else NaN (reference: sensor_uss.py:84-111).

        format "img": (N, H*W) full depth -> min over FoV; "sensor": (N,)
        scalar readings.
        """
        depths = np.asarray(depths, np.float64)
        out = np.full((depths.shape[0], self.W * self.H), np.nan)
        if format == "img":
            with np.errstate(all="ignore"):
                d_min = np.nanmin(depths[:, self.mask], axis=1)
        elif format == "sensor":
            d_min = depths
        else:
            raise ValueError(f"unknown depth format {format}")
        out[:, self.mask] = d_min[:, None]
        return out


class ToFModel(SensorModel):
    """Infrared time-of-flight 8x8 zone array mapped onto camera pixels
    (reference: sensor_tof.py:32-148)."""

    def __init__(
        self,
        img_wh,
        camera_aov_deg,
        aov_sensor_deg=(45.0, 45.0),
        matrix=(8, 8),
        tof_pix_size: int = 1,
        sensor_calibration_error: float = 0.0,
        sensor_random_error: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(img_wh, camera_aov_deg)
        self.aov_sensor = aov_sensor_deg
        self.matrix = matrix
        self.tof_pix_size = tof_pix_size
        self.sensor_calibration_error = sensor_calibration_error
        self.sensor_random_error = sensor_random_error
        self.rng = rng or np.random.default_rng(21)
        self.mask, self.idxs_h, self.idxs_w = self._create_mask()
        self.error_mask = self._create_error_mask()

    def _create_mask(self):
        # 8x8 pixel lattice centered in the camera frame
        # (reference: sensor_tof.py:80-109)
        pix_wh = self.aov2pixel(self.aov_sensor)
        idxs_w = np.linspace(0, pix_wh[0], self.matrix[0], dtype=float)
        idxs_h = np.linspace(0, pix_wh[1], self.matrix[1], dtype=float)
        idxs_w = idxs_w + (self.W - pix_wh[0]) / 2
        idxs_h = idxs_h + (self.H - pix_wh[1]) / 2
        ih, iw = self.pos2idx(idxs_h, idxs_w)
        ih, iw = np.meshgrid(ih, iw, indexing="ij")
        mask = np.zeros((self.H, self.W), bool)
        mask[ih, iw] = True
        return mask.flatten(), ih.flatten(), iw.flatten()

    def _create_error_mask(self):
        # calibration error: the sensed pixel lattice is shifted but readings
        # are assigned to the nominal lattice (reference: sensor_tof.py:111-148)
        if self.sensor_calibration_error == 0.0:
            return self.mask.copy()
        direction = 0.0
        err = self.sensor_calibration_error * np.array(
            [np.cos(direction), np.sin(direction)]
        )
        err[0] = self.H * err[0] / self.camera_aov[0]
        err[1] = self.W * err[1] / self.camera_aov[1]
        err = np.round(err).astype(int)
        m = self.mask.reshape(self.H, self.W)
        idx = np.argwhere(m)
        idx[:, 0] = np.clip(idx[:, 0] + err[0], 0, self.H - 1)
        idx[:, 1] = np.clip(idx[:, 1] + err[1], 0, self.W - 1)
        em = np.zeros((self.H, self.W), bool)
        em[idx[:, 0], idx[:, 1]] = True
        return em.flatten()

    def convert_depth(self, depths, format="img"):
        """Scatter zone depths onto the pixel lattice, optionally dilate to
        ``tof_pix_size`` blocks and inject Gaussian noise
        (reference: sensor_tof.py:32-78)."""
        depths = np.asarray(depths, np.float64)
        out = np.zeros((depths.shape[0], self.H * self.W), np.float64)
        if format == "img":
            out[:, self.mask] = np.nan_to_num(depths[:, self.error_mask], nan=0.0)
        elif format == "sensor":
            out[:, self.mask] = np.nan_to_num(depths, nan=0.0)
        else:
            raise ValueError(f"unknown depth format {format}")

        if self.tof_pix_size > 1 and _HAVE_SCIPY:
            out = out.reshape(-1, self.H, self.W)
            out = grey_dilation(
                out, size=(1, self.tof_pix_size, self.tof_pix_size)
            )
            out = out.reshape(-1, self.H * self.W)
        out[out == 0.0] = np.nan

        if self.sensor_random_error:
            valid = ~np.isnan(out)
            noise = self.rng.normal(0.0, self.sensor_random_error, out.shape)
            out[valid] += noise[valid]
        return out
