"""loss_ms.train (ms): the device time a step of the operations launched
under the program's ``yolodl.loss`` spans (``yolo_loss`` with its matcher,
or the darknet loss; the loss's backward is the backward's), averaged over
whole steps (``spans.py``).  Device trace; moves train_img_s."""

from h100bench.spans import phase_ms


def read(r):
    trace = r.get("trace")
    return None if trace is None else phase_ms(trace, "yolodl.loss")
