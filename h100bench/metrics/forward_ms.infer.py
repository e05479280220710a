"""forward_ms.infer (ms): the device time of the kernels that the
benchmark's range ``h100bench.forward`` (the model on one batch, its
upload and cast included) launched, per traced batch.  Device trace;
moves infer_img_s."""


def read(r):
    trace = r.get("trace")
    if trace is None:
        return None
    batches = [ops for ops in trace.device_under("h100bench.forward") if ops]
    if not batches:
        return None
    return sum(e - s for ops in batches for _, s, e in ops) / len(batches) / 1e6
