"""to_host_idle_ms.infer (ms): for each of the program's
``yolodl.inference.to_host`` spans (``to_host_detections``: the
detections' download and unpacking) that ended in the traced span, the
part of it, clipped to the traced span, in which no device operation ran,
averaged over the batches (``spans.py``).  Device trace; moves
infer_img_s."""

from h100bench.spans import idle_ms


def read(r):
    trace = r.get("trace")
    return None if trace is None else idle_ms(trace, "yolodl.inference.to_host")
