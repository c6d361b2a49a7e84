from .adm import ADMUNet, make_adm_diffusion_model
from .diffusion import GaussianDiffusion, make_diffusion_model
from .fdnunet import (
    FDNUNet,
    FDNUNetAuxDecoder,
    FDNUNetDecoder,
    FDNUNetEncoder,
    create_models,
    predict,
)
from .unet import UNet

__all__ = [
    "ADMUNet",
    "FDNUNet",
    "FDNUNetAuxDecoder",
    "FDNUNetDecoder",
    "FDNUNetEncoder",
    "GaussianDiffusion",
    "UNet",
    "create_models",
    "make_adm_diffusion_model",
    "make_diffusion_model",
    "predict",
]
