"""update_ms.train (ms): the device time a step of the operations launched
under the program's ``yolodl.train.update`` spans (from the last
micro-batch's end: the gradient's division over the micro-batches, the
metrics' combine, clipping, Adam, the BN variance clamp, EMA), averaged
over whole steps (``spans.py``).  Device trace; moves train_img_s."""

from h100bench.spans import phase_ms


def read(r):
    trace = r.get("trace")
    return None if trace is None else phase_ms(trace, "yolodl.train.update")
