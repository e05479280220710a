from .boxes import (  # noqa: F401
    box_iou_pairwise,
    cycxhw_to_tlbr,
    intersect_area,
)
from .transform import Transform  # noqa: F401
