"""launches.train (ops): the device operations (kernels, copies, sets)
launched under the program's ``yolodl.train.step`` span, on any thread, a
step, averaged over whole steps (``spans.py``).  Device trace; moves
train_img_s."""

from h100bench.spans import step_launches


def read(r):
    trace = r.get("trace")
    return None if trace is None else step_launches(trace)
