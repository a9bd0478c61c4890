"""Model zoo: importing this package populates the registry.

Registered `type` strings match the JAX package's (`dlwpbench_tpu/models/
__init__.py`) so the same `configs/model/*.yaml` build either side.  Ported
so far: the U-Net and the Swin Transformer (global or local windows), each
on the equirectangular grid and on HEALPix (`UNetHPX`,
`SwinTransformerHPX`), Pangu-Weather, the ModernUNet and its diffusion
model, each on both meshes (`ModernUNet`, `MUNetHPX`, `DiffModernUNet`,
`DiffMUNetHPX`), and the recurrent ConvLSTM and DISTANA, each on both
meshes (`ConvLSTM`, `ConvLSTMHPX`, `DISTANA`, `DISTANAHPX`).  Any other
type raises the registry's KeyError.
"""

from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models.convlstm import ConvLSTM, ConvLSTMHPX
from dlwpbench_tpu_torch.models.distana import DISTANA, DISTANAHPX
from dlwpbench_tpu_torch.models.modern_unet import (
    DiffModernUNet,
    DiffMUNetHPX,
    ModernUNet,
    MUNetHPX,
)
from dlwpbench_tpu_torch.models.pangu import PanguWeather
from dlwpbench_tpu_torch.models.swin import SwinTransformer, SwinTransformerHPX
from dlwpbench_tpu_torch.models.unet import UNet, UNetHPX

registry.register("ConvLSTM")(ConvLSTM)
registry.register("ConvLSTMHPX")(ConvLSTMHPX)
registry.register("DISTANA")(DISTANA)
registry.register("DISTANAHPX")(DISTANAHPX)
registry.register("DiffModernUNet")(DiffModernUNet)
registry.register("DiffMUNetHPX")(DiffMUNetHPX)
registry.register("ModernUNet")(ModernUNet)
registry.register("MUNetHPX")(MUNetHPX)
registry.register("PanguWeather")(PanguWeather)
registry.register("SwinTransformer")(SwinTransformer)
registry.register("SwinTransformerHPX")(SwinTransformerHPX)
registry.register("UNet")(UNet)
registry.register("UNetHPX")(UNetHPX)
