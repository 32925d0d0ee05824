from sstem_tpu_torch.models.ifnet import IFNet
from sstem_tpu_torch.models.fusionnet import FusionNet
from sstem_tpu_torch.models.unet_sff import UNetSFF
from sstem_tpu_torch.models.unet_sp import FusionNetSP, UNetSP

__all__ = ["IFNet", "FusionNet", "FusionNetSP", "UNetSFF", "UNetSP"]
