"""Command-line entry points of the port: `python -m
jpeg_detection_resnet_ssd_torch.cli {evaluate,compute-map,infer}` (see
`cli/main.py`)."""
