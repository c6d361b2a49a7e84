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
    "FDNUNet",
    "FDNUNetAuxDecoder",
    "FDNUNetDecoder",
    "FDNUNetEncoder",
    "GaussianDiffusion",
    "UNet",
    "create_models",
    "make_diffusion_model",
    "predict",
]
