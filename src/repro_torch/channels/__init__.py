"""The radio environment (port of ``repro/channels``): one ``ChannelModel``
registry behind three axes, all declared in ``ChannelConfig`` and sweepable
(``channel.model``, ``channel.rho``, ``channel.csi_error``, ...):

* the small-scale process (``models``): i.i.d. Rayleigh (the default),
  Rician with a K-factor, Gauss-Markov AR(1);
* the large-scale geometry (``geometry``): distances, path loss and
  shadowing to per-device means;
* imperfect CSI (``csi``): the true ``h`` of the air against the server's
  estimate ``h_hat``.
"""
from repro_torch.channels.base import ChannelModel, get, names, register
from repro_torch.channels.csi import CSI_ERROR_MODELS, estimate
from repro_torch.channels.geometry import (GeometryConfig, draw_distances,
                                           relative_gains)
from repro_torch.channels import models as _models  # noqa: F401  (registers)
from repro_torch.channels import csi, geometry  # noqa: F401

__all__ = ["CSI_ERROR_MODELS", "ChannelModel", "GeometryConfig", "csi",
           "draw_distances", "estimate", "geometry", "get", "names",
           "register", "relative_gains"]
