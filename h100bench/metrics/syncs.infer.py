"""syncs.infer (calls): the runtime calls a detect batch made under the
program's ``yolodl.*`` spans that block the host on the device (stream,
device or event synchronize; a copy to the host), each outermost span's
name averaged over its spans (``spans.py``).  Device trace; moves
infer_img_s."""

from h100bench.spans import batch_syncs


def read(r):
    trace = r.get("trace")
    return None if trace is None else batch_syncs(trace)
