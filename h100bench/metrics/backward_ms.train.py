"""backward_ms.train (ms): the device time a step of the operations launched,
on autograd's thread as on the caller's, while the program's
``yolodl.train.backward`` spans (each micro-batch's ``.backward()``) were
open, averaged over whole steps (``spans.py``).  Device trace; moves
train_img_s."""

from h100bench.spans import phase_ms


def read(r):
    trace = r.get("trace")
    return None if trace is None else phase_ms(trace, "yolodl.train.backward")
