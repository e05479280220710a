"""forward_ms.train (ms): the device time a step of the operations launched
under the program's ``yolodl.model.forward`` spans (``YoloModel.forward``,
each micro-batch's), on any thread, averaged over the whole
``yolodl.train.step`` spans of the trace (``spans.py``).  Device trace;
moves train_img_s."""

from h100bench.spans import phase_ms


def read(r):
    trace = r.get("trace")
    return None if trace is None else phase_ms(trace, "yolodl.model.forward")
