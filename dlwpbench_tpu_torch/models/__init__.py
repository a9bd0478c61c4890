"""Model zoo: importing this package populates the registry.

Registered `type` strings match the JAX package's (`dlwpbench_tpu/models/
__init__.py`) so the same `configs/model/*.yaml` build either side.  Ported
so far: the U-Net and the Swin Transformer (global or local windows), each
on the equirectangular grid and on HEALPix (`UNetHPX`,
`SwinTransformerHPX`), Pangu-Weather, the ModernUNet and its diffusion
model, each on both meshes (`ModernUNet`, `MUNetHPX`, `DiffModernUNet`,
`DiffMUNetHPX`), and the recurrent ConvLSTM and DISTANA, each on both
meshes (`ConvLSTM`, `ConvLSTMHPX`, `DISTANA`, `DISTANAHPX`), and the
spectral families: FNO and TFNO (`FNO2DModule`, `TFNO2DModule`),
FourCastNet (`FourCastNet`, and `FourCastNetv2`, the same class with the
SFNO filter) and SFNO (`SFNO2DModule`), and the graph families: GraphCast
on the icosahedral multimesh (`GraphCastNet`) and MeshGraphNet on its grid
graphs (`MeshGraphNet`).  That is every type the JAX registry holds; any
other type raises the registry's KeyError.
"""

from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models.convlstm import ConvLSTM, ConvLSTMHPX
from dlwpbench_tpu_torch.models.distana import DISTANA, DISTANAHPX
from dlwpbench_tpu_torch.models.fno import FNO2DModule, TFNO2DModule
from dlwpbench_tpu_torch.models.fourcastnet import FourCastNet
from dlwpbench_tpu_torch.models.graphcast import GraphCastNet
from dlwpbench_tpu_torch.models.mgn import MeshGraphNet
from dlwpbench_tpu_torch.models.modern_unet import (
    DiffModernUNet,
    DiffMUNetHPX,
    ModernUNet,
    MUNetHPX,
)
from dlwpbench_tpu_torch.models.pangu import PanguWeather
from dlwpbench_tpu_torch.models.sfno import SFNO2DModule
from dlwpbench_tpu_torch.models.swin import SwinTransformer, SwinTransformerHPX
from dlwpbench_tpu_torch.models.unet import UNet, UNetHPX

registry.register("ConvLSTM")(ConvLSTM)
registry.register("ConvLSTMHPX")(ConvLSTMHPX)
registry.register("DISTANA")(DISTANA)
registry.register("DISTANAHPX")(DISTANAHPX)
registry.register("DiffModernUNet")(DiffModernUNet)
registry.register("DiffMUNetHPX")(DiffMUNetHPX)
registry.register("FNO2DModule")(FNO2DModule)
registry.register("FourCastNet")(FourCastNet)
registry.register("FourCastNetv2")(FourCastNet)  # filter: SFNO in its config
registry.register("GraphCastNet")(GraphCastNet)
registry.register("MeshGraphNet")(MeshGraphNet)
registry.register("ModernUNet")(ModernUNet)
registry.register("MUNetHPX")(MUNetHPX)
registry.register("PanguWeather")(PanguWeather)
registry.register("SFNO2DModule")(SFNO2DModule)
registry.register("SwinTransformer")(SwinTransformer)
registry.register("SwinTransformerHPX")(SwinTransformerHPX)
registry.register("TFNO2DModule")(TFNO2DModule)
registry.register("UNet")(UNet)
registry.register("UNetHPX")(UNetHPX)
