"""Weight carriers between the JAX package, Keras H5 files and the port:
the flax bridge, H5 import and export by layer name, the checksum-verified
weight fetch (local files and a pre-staged cache; nothing is downloaded)
and head surgery across class counts."""

from jpeg_detection_resnet_ssd_torch.compat.fetch import (
    ChecksumError,
    fetch_known_weights,
    fetch_weights,
    file_checksum,
    verify_checksum,
)
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import flax_variables, load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.h5_export import export_keras_h5
from jpeg_detection_resnet_ssd_torch.compat.h5_import import (
    import_weights_by_name,
    list_h5_layers,
    load_keras_h5_weights,
)
from jpeg_detection_resnet_ssd_torch.compat.surgery import sample_tensors

__all__ = [
    "ChecksumError",
    "export_keras_h5",
    "fetch_known_weights",
    "fetch_weights",
    "file_checksum",
    "flax_variables",
    "import_weights_by_name",
    "list_h5_layers",
    "load_flax_variables",
    "load_keras_h5_weights",
    "sample_tensors",
    "verify_checksum",
]
