from .inference import YoloInferenceOutput, to_host_detections, yolo_inference  # noqa: F401
from .nms import NmsOutput, non_max_suppression  # noqa: F401
