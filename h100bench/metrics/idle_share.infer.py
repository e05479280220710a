"""idle_share.infer (%): the share of the traced span in which no kernel,
copy or set ran on the device: 1 - busy_s / window_s.  Device trace;
moves infer_img_s."""


def read(r):
    trace = r.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
