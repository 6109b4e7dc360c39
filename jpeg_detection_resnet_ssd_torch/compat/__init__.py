"""Weight carriers between the JAX package and the port."""

from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import load_flax_variables

__all__ = ["load_flax_variables"]
