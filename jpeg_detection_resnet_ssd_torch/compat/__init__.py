"""Weight carriers between the JAX package, Keras H5 files and the port.

`compat/surgery.py`, `compat/h5_export.py` and `compat/fetch.py` of the JAX
package are ROADMAP A14c (the serving half of A14 is `serve/`)."""

from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import flax_variables, load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.h5_import import (
    import_weights_by_name,
    list_h5_layers,
    load_keras_h5_weights,
)

__all__ = [
    "flax_variables",
    "import_weights_by_name",
    "list_h5_layers",
    "load_flax_variables",
    "load_keras_h5_weights",
]
