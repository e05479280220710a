from .inference import YoloInferenceOutput, to_host_detections, yolo_inference  # noqa: F401
from .nms import NmsOutput, non_max_suppression  # noqa: F401
from .matcher import MatcherConfig, MatchingOutput, match_targets  # noqa: F401
from .yolo_loss import LossAuxiliary, LossConfig, LossOutput, yolo_loss  # noqa: F401
