"""Layer functions of the darknet graph, NCHW tensors."""
