"""launches.infer (ops): the device operations a detect batch launched under
the program's ``yolodl.model.forward``, ``yolodl.nms`` and
``yolodl.inference.select`` spans, each averaged over its whole spans
(``spans.py``).  Device trace; moves infer_img_s."""

from h100bench.spans import batch_launches

NAMES = ("yolodl.model.forward", "yolodl.nms", "yolodl.inference.select")


def read(r):
    trace = r.get("trace")
    return None if trace is None else batch_launches(trace, NAMES)
