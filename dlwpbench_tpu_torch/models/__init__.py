"""Model zoo: importing this package populates the registry.

Registered `type` strings match the JAX package's (`dlwpbench_tpu/models/
__init__.py`) so the same `configs/model/*.yaml` build either side.  Ported
so far: the Swin Transformer (equirectangular, global or local windows)
and Pangu-Weather.
"""

from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models.pangu import PanguWeather
from dlwpbench_tpu_torch.models.swin import SwinTransformer

registry.register("PanguWeather")(PanguWeather)
registry.register("SwinTransformer")(SwinTransformer)
