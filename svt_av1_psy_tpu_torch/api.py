"""Public encoder API of the port: svt_av1_psy_tpu.api.Encoder with its
device search in PyTorch.

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    enc = Encoder(cfg, 1920, 1080, device="cuda")
    for (y, u, v) in frames:
        pkt = enc.encode(y, u, v)
    enc.close()

encode / send_picture / flush / close are the reference's, unchanged.
Branches of the reference's routing that the port does not cover yet
raise NotImplementedError naming their ROADMAP item, before anything is
built.
"""

from __future__ import annotations

from svt_av1_psy_tpu import api
from svt_av1_psy_tpu.config import (EncoderConfig, PredStructure,
                                    validate_config)
from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
from svt_av1_psy_tpu_torch.utils.device import resolve_device

__all__ = ["Encoder", "EncoderConfig", "PredStructure"]


def _refuse_unported(cfg: EncoderConfig) -> None:
    """Raise NotImplementedError for the routes of api.Encoder.__init__
    that need device code the port does not have yet."""
    preset = cfg.enc_mode
    if preset < 4:
        raise NotImplementedError(
            f"preset {preset}: presets <= 3 run the full RD funnel "
            "(IntraEncoder, block_mode_costs): ROADMAP queue 1 item 8")
    if cfg.screen_content_mode == 1:
        raise NotImplementedError(
            "--scm 1 runs the full RD funnel (IntraEncoder, "
            "block_mode_costs): ROADMAP queue 1 item 8")
    if cfg.hierarchical_levels and api._gop_from_cfg(cfg) != 1 and \
            cfg.pred_structure == PredStructure.RANDOM_ACCESS:
        raise NotImplementedError(
            "random access (RaDriver, gop_search_tf): ROADMAP queue 1 "
            "items 4-5")
    if cfg.enable_restoration_filtering == 1 or \
            (cfg.enable_restoration_filtering == -1 and preset <= 7):
        raise NotImplementedError(
            "loop restoration (DeviceLrSearch): ROADMAP queue 1 item 6")


class Encoder(api.Encoder):
    """One encode channel whose device search runs in PyTorch on
    ``device`` ("cpu" or "cuda[:N]"; "cuda" without a GPU raises)."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int,
                 bit_depth: int | None = None, *, device: str):
        self.device = resolve_device(device)
        checked = cfg.replace(source_width=width, source_height=height)
        if bit_depth is not None:
            checked = checked.replace(encoder_bit_depth=bit_depth)
        _refuse_unported(validate_config(checked))
        super().__init__(cfg, width, height, bit_depth)
        # the reference routing built its FastIntraEncoder, which holds
        # only host state so far; re-class it to the port's subclass so
        # that every option the routing set carries over unchanged
        assert type(self._enc) is FastIntraEncoder.__base__
        self._enc.__class__ = FastIntraEncoder
        self._enc.device = self.device
