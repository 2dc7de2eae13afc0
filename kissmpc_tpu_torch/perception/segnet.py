"""A real torch instance-segmentation network for the detector boundary.
A port-owned copy of `kissmpc_tpu/perception/segnet.py`.

The reference's perception nodes run ultralytics YOLO11-seg
(`obstacle_handling/detection.py:8-68`, `human_tracking.py:118-121`).  That
network is not part of this repository, so this module provides a genuine
`torch.nn.Module` segmenter (conv backbone + instance head, torchvision
detection output convention) that exercises the same boundary
(`TorchSegmentationAdapter` -> `perception.pipeline.step`) with real tensor
shapes and dtypes.

`TinySegNet` is a per-pixel foreground network (two 3x3 convs) with an
instance head that separates connected foreground regions by iterative
max-pool label flooding (the standard GPU connected-components trick) and
emits the top-M instances by area.  `TinySegNet.brightness()` builds one
with deterministic weights that segment bright blobs, made in code (nothing
is downloaded), so end-to-end tests are reproducible; random init works
too (the boundary contract is about shapes, dtypes and thresholds, not
accuracy).  The instance head reads its flood's convergence and the
instance areas back to the host: it is the detector, outside the tick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device


class TinySegNet(torch.nn.Module):
    """Conv instance segmenter with torchvision-style detection output.

    forward(image [3, H, W] float) -> {"masks": [M, 1, H, W] float,
    "scores": [M] float} — the contract `TorchSegmentationAdapter` consumes
    (same shape family a torchvision Mask R-CNN or exported YOLO-seg head
    produces).
    """

    def __init__(
        self,
        channels: int = 8,
        max_instances: int = 8,
        threshold: float = 0.5,
        min_area: int = 8,
    ):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, channels, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(channels, 1, 3, padding=1)
        self.max_instances = max_instances
        self.threshold = threshold
        self.min_area = min_area

    @classmethod
    def brightness(
        cls, gain: float = 20.0, level: float = 0.5, *, device=None, **kwargs
    ) -> "TinySegNet":
        """Deterministic weights: foreground = pixel brightness > level.
        ``device=None`` puts the network on the card."""
        net = cls(**kwargs).to(resolve_device(device))
        with torch.no_grad():
            net.conv1.weight.zero_()
            net.conv1.bias.zero_()
            # channel 0 = center-tap RGB mean (stays >= 0 through the ReLU)
            net.conv1.weight[0, :, 1, 1] = 1.0 / 3.0
            net.conv2.weight.zero_()
            net.conv2.bias.fill_(-gain * level)
            net.conv2.weight[0, 0, 1, 1] = gain
        return net

    def forward(self, image: torch.Tensor):
        if image.ndim == 3:
            x = image.unsqueeze(0)
        else:
            x = image
        h = F.relu(self.conv1(x))
        prob = torch.sigmoid(self.conv2(h))[0, 0]  # [H, W]
        fg = prob > self.threshold
        H, W = fg.shape

        # Instance separation: iterative 3x3 max-pool label flooding over the
        # foreground support — each sweep propagates the max seed label one
        # pixel, so iterating to fixed point labels each 8-connected
        # component with its max linear index.
        seed = torch.arange(
            1, H * W + 1, dtype=prob.dtype, device=prob.device
        ).reshape(H, W) * fg
        lab = seed[None, None]
        fgf = fg[None, None].to(prob.dtype)
        while True:
            new = F.max_pool2d(lab, 3, stride=1, padding=1) * fgf
            if torch.equal(new, lab):
                break
            lab = new
        lab = lab[0, 0].long()

        M = self.max_instances
        masks = torch.zeros(M, 1, H, W, dtype=prob.dtype, device=prob.device)
        scores = torch.zeros(M, dtype=prob.dtype, device=prob.device)
        ids, counts = torch.unique(lab[lab > 0], return_counts=True)
        order = torch.argsort(counts, descending=True)
        slot = 0
        for idx in order.tolist():
            if int(counts[idx]) < self.min_area or slot >= M:
                break
            inst = lab == ids[idx]
            masks[slot, 0] = inst.to(prob.dtype)
            # mean foreground probability over the instance — each pixel is
            # above `threshold`, so the score clears a 0.5 score_threshold
            scores[slot] = prob[inst].mean()
            slot += 1
        return {"masks": masks, "scores": scores}
