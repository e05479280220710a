"""syncs.train (calls): the runtime calls under the program's
``yolodl.train.step`` span that block the host on the device (stream,
device or event synchronize; a copy to the host), a step, averaged over
whole steps (``spans.py``).  Device trace; moves train_img_s."""

from h100bench.spans import step_syncs


def read(r):
    trace = r.get("trace")
    return None if trace is None else step_syncs(trace)
