"""Model zoo: importing this package populates the registry.

Registered `type` strings match the JAX package's (`dlwpbench_tpu/models/
__init__.py`) so the same `configs/model/*.yaml` build either side.  Ported
so far: the U-Net (equirectangular), the Swin Transformer
(equirectangular, global or local windows) and Pangu-Weather.  The
HEALPix families (`UNetHPX`, ...) are not registered yet (ROADMAP queue A,
item 8): building one raises the registry's KeyError.
"""

from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models.pangu import PanguWeather
from dlwpbench_tpu_torch.models.swin import SwinTransformer
from dlwpbench_tpu_torch.models.unet import UNet

registry.register("PanguWeather")(PanguWeather)
registry.register("SwinTransformer")(SwinTransformer)
registry.register("UNet")(UNet)
