"""Box geometry, anchors and prediction decoding (torch)."""

from jpeg_detection_resnet_ssd_torch.boxes.anchors import (
    SSD300_ASPECT_RATIOS,
    SSD300_SCALES_VOC,
    SSD300_STEPS,
    SSD300_VARIANCES,
    AnchorSpec,
    anchor_grid_for_layer,
    build_anchors,
    n_boxes_per_cell,
)
from jpeg_detection_resnet_ssd_torch.boxes.decode import (
    decode_detections,
    decode_raw_predictions,
    select_candidates,
)
from jpeg_detection_resnet_ssd_torch.boxes.geometry import (
    box_area,
    centroids_to_corners,
    convert,
    corners_to_centroids,
    corners_to_minmax,
    iou_elementwise,
    minmax_to_corners,
)
