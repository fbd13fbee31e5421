"""Output writers of the evaluation CLI (port of ``v2e2v_tpu/utils/data_io.py``).

The reference's on-disk formats: PNG frames named ``frame_%010d.png`` under
``output_folder/model_name/dataset_name``, written as 8-bit gray by
``utils/image_io.write_gray``; tab-separated metric rows appended to
``result.csv`` in the same folder. The event-preview, error-map and panel
writers (used by the V2E2V CLI and the display flags) are not ported.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .image_io import write_gray


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
