"""postprocess_roofline.infer (%): the postprocess stage's bound over its
device time.  The stage is what the benchmark's range
``h100bench.postprocess`` launches for a batch (``non_max_suppression``
with B1's kernels, ``yolo_inference``).  Its bound (``bounds.py``) reads
the dense heads once, counts the suppression's pairs on this batch's
candidates, and writes the kept boxes once; on these inputs it is bound by
bytes.  It counts the work, not a kernel by name.  Device trace; moves
infer_img_s."""

from h100bench.bounds import postprocess_bound_s


def read(r):
    trace = r.get("trace")
    samples = r.get("nms_samples")
    if trace is None or not samples:
        return None
    batches = [ops for ops in trace.device_under("h100bench.postprocess") if ops]
    if not batches:
        return None
    spent = sum(e - s for ops in batches for _, s, e in ops) / len(batches) / 1e9
    bound = sum(postprocess_bound_s(r["dense_bytes"], t, r["iou_thresh"], r["nms_kind"],
                                    r["box_itemsize"])[0] for t in samples) / len(samples)
    return 100.0 * bound / spent
