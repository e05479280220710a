"""mfu.train (%): the whole train step's share of the chip's bf16 peak.
3 x the forward FLOPs of an image (convs only, recompute not counted) x
the images of the steps completed in the measured window, over the time
from the window's start to the last of those completions, over 989
TFLOP/s.  Host clock; moves train_img_s."""

from h100bench.peaks import BF16_FLOPS


def read(r):
    if not r.get("images") or not r.get("measured_s"):
        return None
    return 100.0 * r["passes"] * r["flops_per_image"] * r["images"] / r["measured_s"] / BF16_FLOPS
