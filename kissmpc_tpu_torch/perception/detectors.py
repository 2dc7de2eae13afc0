"""Detector boundary: where a neural segmenter plugs into the pipeline.
A port-owned copy of `kissmpc_tpu/perception/detectors.py`.

The reference runs ultralytics YOLO11-seg inside its perception nodes
(`obstacle_handling/detection.py:8-68` with ROS parameters for
model/device/threshold; `human_tracking.py:118-121,208-213` with
`track(persist=True)`).  The port treats the network as a pluggable
*detector*: anything that maps an image to fixed-size instance masks
(`Detection` below) feeds `perception.pipeline.step`.

Provided implementations:
 * `ThresholdBlobDetector`: dependency-free reference detector (connected
   bright regions by 4-neighbour min-label propagation, in numpy); used by
   tests and demos.
 * `TorchSegmentationAdapter`: wraps any torch module that returns
   per-instance masks/scores (e.g. a torchvision Mask R-CNN or an exported
   YOLO-seg head), runs it on the card unless asked for the CPU, and
   converts to the fixed-shape array contract at the boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from .._device import resolve_device


class Detection(NamedTuple):
    """Fixed-shape per-frame detection output (the pipeline's contract)."""

    masks: np.ndarray  # [M, H, W] bool instance masks (padded)
    valid: np.ndarray  # [M] bool
    scores: np.ndarray  # [M] float


class Detector(Protocol):
    max_instances: int

    def __call__(self, image: np.ndarray) -> Detection: ...


class ThresholdBlobDetector:
    """Bright-blob instance detector (reference implementation, no deps).

    Threshold -> connected components (4-neighbour label sweep) -> top-M
    components by area.  Deterministic stand-in for a neural segmenter in
    tests/demos.
    """

    def __init__(
        self,
        threshold: float = 0.5,
        max_instances: int = 8,
        min_area: int = 8,
    ):
        self.threshold = threshold
        self.max_instances = max_instances
        self.min_area = min_area

    def __call__(self, image: np.ndarray) -> Detection:
        img = np.asarray(image, dtype=np.float64)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        if img.max() > 1.5:  # uint8-style range
            img = img / 255.0
        fg = img > self.threshold
        H, W = fg.shape

        # connected components by iterative min-label propagation
        labels = np.where(fg, np.arange(H * W).reshape(H, W), -1)
        while True:
            new = labels.copy()
            for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
                rolled = np.roll(labels, shift, axis=axis)
                if axis == 0:
                    if shift == 1:
                        rolled[0, :] = -1
                    else:
                        rolled[-1, :] = -1
                else:
                    if shift == 1:
                        rolled[:, 0] = -1
                    else:
                        rolled[:, -1] = -1
                mask = fg & (rolled >= 0)
                new = np.where(
                    mask & ((new < 0) | (rolled < new)), rolled, new
                )
            if np.array_equal(new, labels):
                break
            labels = new

        M = self.max_instances
        masks = np.zeros((M, H, W), dtype=bool)
        valid = np.zeros((M,), dtype=bool)
        scores = np.zeros((M,), dtype=np.float64)
        roots, counts = np.unique(labels[labels >= 0], return_counts=True)
        order = np.argsort(-counts)
        slot = 0
        for idx in order:
            if counts[idx] < self.min_area or slot >= M:
                break
            masks[slot] = labels == roots[idx]
            valid[slot] = True
            scores[slot] = float(counts[idx]) / (H * W)
            slot += 1
        return Detection(masks=masks, valid=valid, scores=scores)


class TorchSegmentationAdapter:
    """Adapter for torch instance-segmentation modules.

    ``model(image_tensor)`` must return a dict with ``masks`` ([M, H, W] or
    [M, 1, H, W] float) and ``scores`` ([M]) — the torchvision detection
    convention.  Output is padded/truncated to ``max_instances`` and
    thresholded at ``mask_threshold``/``score_threshold`` (the reference
    uses conf 0.5, `human_tracking.py:120`).  ``device=None`` runs the model
    on the card; it is moved there.
    """

    def __init__(
        self,
        model,
        max_instances: int = 8,
        score_threshold: float = 0.5,
        mask_threshold: float = 0.5,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.max_instances = max_instances
        self.score_threshold = score_threshold
        self.mask_threshold = mask_threshold

    def __call__(self, image: np.ndarray) -> Detection:
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=0)
        elif img.ndim == 3 and img.shape[-1] in (1, 3):
            img = np.moveaxis(img, -1, 0)
        tensor = torch.from_numpy(img).to(self.device)
        with torch.no_grad():
            out = self.model(tensor)
        if isinstance(out, (list, tuple)):
            out = out[0]
        raw_masks = out["masks"].detach().cpu().numpy()
        scores = out["scores"].detach().cpu().numpy()
        if raw_masks.ndim == 4:
            raw_masks = raw_masks[:, 0]
        H, W = raw_masks.shape[-2:]
        M = self.max_instances
        masks = np.zeros((M, H, W), dtype=bool)
        valid = np.zeros((M,), dtype=bool)
        out_scores = np.zeros((M,), dtype=np.float64)
        slot = 0
        for i in np.argsort(-scores):
            if scores[i] < self.score_threshold or slot >= M:
                break
            masks[slot] = raw_masks[i] > self.mask_threshold
            valid[slot] = True
            out_scores[slot] = float(scores[i])
            slot += 1
        return Detection(masks=masks, valid=valid, scores=out_scores)


def mask_bounding_box(mask: np.ndarray):
    """(r0, c0, r1, c1) inclusive-exclusive bbox of a boolean mask, or None."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return None
    r0, r1 = np.nonzero(rows)[0][[0, -1]]
    c0, c1 = np.nonzero(cols)[0][[0, -1]]
    return int(r0), int(c0), int(r1) + 1, int(c1) + 1


def render_annotated(
    image: np.ndarray,
    detection: Detection,
    *,
    alpha: float = 0.35,
    box_intensity: float = 1.0,
):
    """Annotated + segmentation images for a frame (pure numpy).

    The reference's detection node publishes an annotated image (YOLO's
    `result.plot()`) and a binary segmentation image next to the raw frame
    (`obstacle_handling/detection.py:43-68`); this is the dependency-free
    equivalent for any `Detection`: instance masks are alpha-blended with a
    per-instance shade and bounding boxes drawn at full intensity.

    ``image``: [H, W] grayscale or [H, W, C]; float in [0, 1] or uint8.
    Returns ``(annotated, segmentation)`` with ``annotated`` matching the
    input dtype/shape and ``segmentation`` a [H, W] uint8 instance-id map
    (0 = background, i+1 = instance i — the padded-slot ids are skipped).
    """
    img = np.asarray(image)
    was_uint8 = img.dtype == np.uint8
    out = img.astype(np.float64) / (255.0 if was_uint8 else 1.0)
    if out.ndim == 2:
        out = out[..., None]
    H, W = out.shape[:2]
    seg = np.zeros((H, W), np.uint8)
    n_valid = int(np.sum(detection.valid))
    for i in range(detection.masks.shape[0]):
        if not detection.valid[i]:
            continue
        mask = detection.masks[i].astype(bool)
        if mask.shape != (H, W):
            raise ValueError(f"mask {mask.shape} vs image {(H, W)}")
        seg[mask] = i + 1
        shade = 0.35 + 0.6 * (i + 1) / max(1, n_valid)
        out[mask] = (1 - alpha) * out[mask] + alpha * shade
        bbox = mask_bounding_box(mask)
        if bbox is not None:
            r0, c0, r1, c1 = bbox
            out[r0, c0:c1] = box_intensity
            out[r1 - 1, c0:c1] = box_intensity
            out[r0:r1, c0] = box_intensity
            out[r0:r1, c1 - 1] = box_intensity
    if np.asarray(image).ndim == 2:
        out = out[..., 0]
    if was_uint8:
        out = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    return out, seg
