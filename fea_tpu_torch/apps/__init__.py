"""Application problems (cantilever, gusset, shearblade, composite) solved,
rendered and scored end to end; the port of fea_tpu/apps."""

from .specs import APPLICATIONS, ApplicationSpec
from .runner import run_application

__all__ = ["APPLICATIONS", "ApplicationSpec", "run_application"]
