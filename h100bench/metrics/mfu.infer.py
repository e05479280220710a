"""mfu.infer (%): the whole detect batch's share of the chip's bf16 peak.
The forward FLOPs of an image (convs only) x the images whose
detections reached the host inside the measured window, over the time
from the window's start to the last of those completions, over 989
TFLOP/s.  Host clock; moves infer_img_s."""

from h100bench.peaks import BF16_FLOPS


def read(r):
    if not r.get("images") or not r.get("measured_s"):
        return None
    return 100.0 * r["passes"] * r["flops_per_image"] * r["images"] / r["measured_s"] / BF16_FLOPS
