"""Output writers of the evaluation CLI (port of ``v2e2v_tpu/utils/data_io.py``).

The reference's on-disk formats: PNG frames named ``frame_%010d.png`` under
``output_folder/model_name/dataset_name``, written as 8-bit gray by
``utils/image_io.write_gray``; tab-separated metric rows appended to
``result.csv`` in the same folder; for the V2E2V CLI, event previews as
``events/events_%010d.png`` and ``--display_test`` panels as
``display/panel_%010d.png``, both 8-bit RGB by ``utils/image_io.write_rgb``.
``ErrorMapWriter`` (matplotlib, which no CLI calls) is not ported.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .image_io import write_gray, write_rgb


def make_event_preview(
    events: np.ndarray, mode: str = "grayscale", num_bins_to_show: int = -1
) -> np.ndarray:
    """Render a voxel grid ``[C, H, W]`` or ``[1, C, H, W]`` (bins first) to a
    preview image: the sum of the last ``num_bins_to_show`` bins (all when
    negative). 'red-blue' is ``[H, W, 3]`` uint8 with 255 in channel 0 where
    the sum is positive and in channel 2 where it is negative (the
    reference's BGR order kept, so a PNG shows positive events red);
    'grayscale' maps the sum clipped to +-5 onto 0-255 (truncated)."""
    if events.ndim == 3:
        events = events[None]
    if num_bins_to_show < 0:
        sum_events = np.sum(events[0], axis=0)
    else:
        sum_events = np.sum(events[0, -num_bins_to_show:], axis=0)

    if mode == "red-blue":
        preview = np.zeros((*sum_events.shape, 3), dtype=np.uint8)
        preview[..., 0][sum_events > 0] = 255
        preview[..., 2][sum_events < 0] = 255
        return preview
    m, big = -5.0, 5.0
    return np.clip(255.0 * (sum_events - m) / (big - m), 0, 255).astype(np.uint8)


class Writer:
    def __init__(self, cfgs, model_name: str, dataset_name: str | None = None):
        self.output_folder = cfgs.output_folder
        self.dataset_name = dataset_name or cfgs.test_data_name
        os.makedirs(self.output_folder, exist_ok=True)
        self.output_data_folder = os.path.join(
            self.output_folder, model_name, f"{self.dataset_name}"
        )


class EvalWriter(Writer):
    """Append per-sequence metric rows to ``result.csv`` (tab-separated)."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.is_write_image = cfgs.is_write_image
        if self.is_write_image:
            os.makedirs(self.output_data_folder, exist_ok=True)
            self.output_txt_file = os.path.join(self.output_data_folder, "result.csv")

    def __call__(self, name_results, results):
        if not self.is_write_image:
            return
        with open(self.output_txt_file, "a+", newline="") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(name_results)
            writer.writerow(results)


class ImageWriter(Writer):
    """Write each reconstruction as ``frame_{id:010d}.png`` (8-bit gray)."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.is_write_image = cfgs.is_write_image
        if self.is_write_image:
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, img, img_id: int):
        if not self.is_write_image:
            return
        write_gray(
            os.path.join(self.output_data_folder, f"frame_{img_id:010d}.png"), np.uint8(img)
        )


class EventWriter(Writer):
    """Write each event preview as ``events/events_{id:010d}.png`` (8-bit
    RGB, or gray for a 2-D preview) when ``--is_write_event`` is set."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.is_write_event = cfgs.is_write_event
        if self.is_write_event:
            self.output_data_folder = os.path.join(self.output_data_folder, "events")
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, img, img_id: int):
        if not self.is_write_event:
            return
        img = np.uint8(img)
        write = write_rgb if img.ndim == 3 else write_gray
        write(os.path.join(self.output_data_folder, f"events_{img_id:010d}.png"), img)


class DebugPanelWriter(Writer):
    """The reference's interactive displays, headless: the panels side by
    side (each float panel min-max normalised to uint8 with rounding, uint8
    panels as they are, gray ones as three equal channels), 2-pixel white
    separators, shorter panels padded at the bottom with black, written as
    ``display/panel_%010d.png``."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.panel_folder = os.path.join(self.output_data_folder, "display")
        os.makedirs(self.panel_folder, exist_ok=True)

    @staticmethod
    def _to_u8(img: np.ndarray) -> np.ndarray:
        img = np.squeeze(np.asarray(img))
        if img.dtype == np.uint8:
            u8 = img
        else:
            img = img.astype(np.float64)
            lo, hi = float(img.min()), float(img.max())
            u8 = np.uint8(np.round(255.0 * (img - lo) / (hi - lo + 1e-12)))
        if u8.ndim == 2:
            u8 = np.stack([u8] * 3, axis=-1)
        return u8

    def __call__(self, panels, idx: int) -> str:
        """panels: a list of 2-D or 3-D arrays (float of any range, or uint8)."""
        imgs = [self._to_u8(p) for p in panels]
        h = max(im.shape[0] for im in imgs)
        sep = np.full((h, 2, 3), 255, np.uint8)
        row = []
        for i, im in enumerate(imgs):
            if im.shape[0] < h:
                im = np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))
            row.append(im)
            if i < len(imgs) - 1:
                row.append(sep)
        path = os.path.join(self.panel_folder, f"panel_{idx:010d}.png")
        write_rgb(path, np.concatenate(row, axis=1))
        return path
