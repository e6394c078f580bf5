"""Public encoder API of the port: svt_av1_psy_tpu.api.Encoder with its
device search in PyTorch.

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    enc = Encoder(cfg, 1920, 1080, device="cuda")
    for (y, u, v) in frames:
        pkt = enc.encode(y, u, v)
    enc.close()

Random access (the default pred_structure, with hierarchical_levels set)
goes through send_picture / flush as in the reference:

    enc = Encoder(EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=5,
                                intra_period_length=-1), 1920, 1080,
                  device="cuda")
    pkts = [p for f in frames for p in enc.send_picture(*f)] + enc.flush()

Presets <= 3 and --scm 1 run the full-RD IntraEncoder, as in the
reference; at the fast presets a key frame that --scm 2 (the default)
flags as screen content goes through it too. Loop restoration (on by
default at presets <= 7) runs its search program on the same device.

encode / send_picture / flush / close are the reference's, unchanged.
Multi-device runs (make_sharded_decide, gop_meshes) raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from svt_av1_psy_tpu import api
from svt_av1_psy_tpu.config import (EncoderConfig, PredStructure,
                                    validate_config)
from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
from svt_av1_psy_tpu_torch.models.intra_encoder import IntraEncoder
from svt_av1_psy_tpu_torch.models.ra import RaDriver
from svt_av1_psy_tpu_torch.utils.device import resolve_device

__all__ = ["Encoder", "EncoderConfig", "PredStructure"]

# the port's subclass of each encoder class the reference routing builds
_PORT_CLASS = {cls.__base__: cls for cls in (FastIntraEncoder, IntraEncoder)}


def _is_random_access(cfg: EncoderConfig) -> bool:
    """The condition of the reference routing's RaDriver branch
    (api.Encoder.__init__): the fast route (preset >= 4, --scm not 1)
    with a random-access pyramid."""
    return cfg.enc_mode >= 4 and cfg.screen_content_mode != 1 \
        and bool(cfg.hierarchical_levels) and api._gop_from_cfg(cfg) != 1 \
        and cfg.pred_structure == PredStructure.RANDOM_ACCESS


class Encoder(api.Encoder):
    """One encode channel whose device search runs in PyTorch on
    ``device`` ("cpu" or "cuda[:N]"; "cuda" without a GPU raises)."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int,
                 bit_depth: int | None = None, *, device: str):
        self.device = resolve_device(device)
        checked = cfg.replace(source_width=width, source_height=height)
        if bit_depth is not None:
            checked = checked.replace(encoder_bit_depth=bit_depth)
        checked = validate_config(checked)
        ra_route = _is_random_access(checked)
        # the reference routing would build the reference RaDriver, whose
        # constructor starts a warm-up thread that imports jax: route a
        # random-access config as flat there, and build the port's RaDriver
        # below from the RA branch of that routing
        super().__init__(cfg.replace(hierarchical_levels=0) if ra_route
                         else cfg, width, height, bit_depth)
        # the reference routing built its FastIntraEncoder or IntraEncoder,
        # which hold only host state so far; re-class it to the port's
        # subclass so that every option the routing set carries over
        # unchanged
        self._enc.__class__ = _PORT_CLASS[type(self._enc)]
        self._enc.device = self.device
        if ra_route:
            self.cfg = checked
            self._route_random_access(self._enc, api._gop_from_cfg(checked))

    def _route_random_access(self, enc: FastIntraEncoder, gop: int) -> None:
        """The RA branch of api.Encoder.__init__ with the port's RaDriver
        (tests/test_torch_ra_encode.py guards the copy against drift)."""
        enc.qp_scale_compress_strength = \
            self.cfg.qp_scale_compress_strength
        self._ra = RaDriver(
            enc, gop_levels=min(self.cfg.hierarchical_levels, 5),
            keyint=0 if gop == 0 else gop,
            tf_strength=(self.cfg.tf_strength
                         if self.cfg.enable_tf else 0),
            tf_adaptive=self.cfg.enable_tf == 2,
            # dynamic mini-GoP follows content analysis (ref
            # Docs/Appendix-Dynamic-Mini-GoP)
            dynamic_gop=bool(self.cfg.scene_change_detection))
        # TPL r0/beta per-frame q from the GoP dependency flow (ref
        # src_ops_process.c:1784 tpl_mc_flow -> rc_process.c:873 CRF
        # qindex from r0)
        if self.cfg.enable_tpl_la:
            self._ra.tpl_strength = 1.0
