"""Box geometry, anchors, prediction decoding, matching and target
encoding (torch)."""

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
    intersection_area_matrix,
    iou_elementwise,
    iou_matrix,
    minmax_to_corners,
)
from jpeg_detection_resnet_ssd_torch.boxes.matching import match_bipartite_greedy, match_multi
from jpeg_detection_resnet_ssd_torch.boxes.target_encoder import TargetEncoder, encode_targets
