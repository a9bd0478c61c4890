"""Model zoo: importing this package populates the registry.

Registered `type` strings match the JAX package's (`dlwpbench_tpu/models/
__init__.py`) so the same `configs/model/*.yaml` build either side.  Ported
so far: the U-Net and the Swin Transformer (global or local windows), each
on the equirectangular grid and on HEALPix (`UNetHPX`,
`SwinTransformerHPX`), and Pangu-Weather.  Any other type raises the
registry's KeyError.
"""

from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models.pangu import PanguWeather
from dlwpbench_tpu_torch.models.swin import SwinTransformer, SwinTransformerHPX
from dlwpbench_tpu_torch.models.unet import UNet, UNetHPX

registry.register("PanguWeather")(PanguWeather)
registry.register("SwinTransformer")(SwinTransformer)
registry.register("SwinTransformerHPX")(SwinTransformerHPX)
registry.register("UNet")(UNet)
registry.register("UNetHPX")(UNetHPX)
