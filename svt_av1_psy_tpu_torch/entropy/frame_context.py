"""Per-frame adaptive CDF context.

Mirrors the reference's FRAME_CONTEXT init (ref:
Source/Lib/Codec/cabac_context_model.c svt_av1_default_coef_probs /
init_mode_probs): at frame start every CDF is a fresh copy of the normative
default, with the coefficient families selected by the base-qindex bin.
Symbols adapt the copies in place during tile coding; a future frame may start
from a kept context (primary_ref) — copy() supports that.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu_torch.constants import coef_qctx, tables


class FrameContext:
    """Mutable CDF store for one frame's tile coding."""

    # (attribute, table key, is_q_binned)
    _SPEC = [
        ("partition", "cdf_partition_cdf", False),
        ("skip", "cdf_skip_cdfs", False),
        ("kf_y", "cdf_kf_y_cdf", False),
        ("y_mode", "cdf_y_mode_cdf", False),
        ("uv_mode", "cdf_uv_mode_cdf", False),
        ("angle_delta", "cdf_angle_delta_cdf", False),
        ("filter_intra", "cdf_filter_intra_cdfs", False),
        ("filter_intra_mode", "cdf_filter_intra_mode_cdf", False),
        ("cfl_sign", "cdf_cfl_sign_cdf", False),
        ("cfl_alpha", "cdf_cfl_alpha_cdf", False),
        ("tx_size", "cdf_tx_size_cdf", False),
        ("txfm_partition", "cdf_txfm_partition_cdf", False),
        ("intra_ext_tx", "cdf_intra_ext_tx_cdf", False),
        ("inter_ext_tx", "cdf_inter_ext_tx_cdf", False),
        ("delta_q", "cdf_delta_q_cdf", False),
        # coefficient families (selected by qindex bin at init)
        ("txb_skip", "cdf_txb_skip_q", True),
        ("eob_flag16", "cdf_eob_flag16_q", True),
        ("eob_flag32", "cdf_eob_flag32_q", True),
        ("eob_flag64", "cdf_eob_flag64_q", True),
        ("eob_flag128", "cdf_eob_flag128_q", True),
        ("eob_flag256", "cdf_eob_flag256_q", True),
        ("eob_flag512", "cdf_eob_flag512_q", True),
        ("eob_flag1024", "cdf_eob_flag1024_q", True),
        ("eob_extra", "cdf_eob_extra_q", True),
        ("coeff_base_eob", "cdf_coeff_base_eob_multi_q", True),
        ("coeff_base", "cdf_coeff_base_multi_q", True),
        ("coeff_br", "cdf_coeff_lps_multi_q", True),
        ("dc_sign", "cdf_dc_sign_q", True),
        # inter-frame families (present for parity; used by the inter path)
        ("intra_inter", "cdf_intra_inter_cdf", False),
        ("skip_mode", "cdf_skip_mode_cdfs", False),
        ("newmv", "cdf_newmv_cdf", False),
        ("zeromv", "cdf_zeromv_cdf", False),
        ("refmv", "cdf_refmv_cdf", False),
        ("drl", "cdf_drl_cdf", False),
        ("single_ref", "cdf_single_ref_cdf", False),
        ("comp_inter", "cdf_comp_inter_cdf", False),
        ("comp_ref_type", "cdf_comp_ref_type_cdf", False),
        ("uni_comp_ref", "cdf_uni_comp_ref_cdf", False),
        ("comp_ref", "cdf_comp_ref_cdf", False),
        ("comp_bwdref", "cdf_comp_bwdref_cdf", False),
        ("inter_compound_mode", "cdf_inter_compound_mode_cdf", False),
        ("switchable_interp", "cdf_switchable_interp_cdf", False),
        ("nmv_joints", "cdf_nmv_joints_cdf", False),
        ("interintra", "cdf_interintra_cdf", False),
        ("interintra_mode", "cdf_interintra_mode_cdf", False),
        ("wedge_interintra", "cdf_wedge_interintra_cdf", False),
        ("wedge_idx", "cdf_wedge_idx_cdf", False),
        ("compound_type", "cdf_compound_type_cdf", False),
        ("seg_id", "cdf_seg_spatial_pred_seg_cdf", False),
        ("seg_pred", "cdf_seg_pred_cdf", False),
        ("intrabc", "cdf_intrabc_cdf", False),
        ("palette_y_mode", "cdf_palette_y_mode_cdf", False),
        ("palette_uv_mode", "cdf_palette_uv_mode_cdf", False),
        ("palette_y_size", "cdf_palette_y_size_cdf", False),
        ("palette_uv_size", "cdf_palette_uv_size_cdf", False),
        ("palette_y_color", "cdf_palette_y_color_index_cdf", False),
        ("palette_uv_color", "cdf_palette_uv_color_index_cdf", False),
        ("motion_mode", "cdf_motion_mode_cdf", False),
        ("obmc", "cdf_obmc_cdf", False),
        ("compound_idx", "cdf_compound_index_cdf", False),
        ("comp_group_idx", "cdf_comp_group_idx_cdf", False),
        ("switchable_restore", "cdf_switchable_restore_cdf", False),
        ("wiener_restore", "cdf_wiener_restore_cdf", False),
        ("sgrproj_restore", "cdf_sgrproj_restore_cdf", False),
    ]

    def __init__(self, base_qindex: int):
        t = tables()
        q = coef_qctx(base_qindex)
        for attr, key, qbin in self._SPEC:
            arr = t[key]
            if qbin:
                arr = arr[q]
            setattr(self, attr, arr.astype(np.uint16).copy())
        # nmv component CDFs: comp 0/1 × {classes, class0, bits, class0_fp,
        # fp, sign, class0_hp, hp}
        self.nmv_comp = {}
        for k in t:
            if k.startswith("cdf_nmv_comp"):
                self.nmv_comp[k[len("cdf_nmv_"):]] = \
                    t[k].astype(np.uint16).copy()
        # intrabc DV coder: its own NMV context instance (spec NdvContext)
        self.dv_joints = t["cdf_nmv_joints_cdf"].astype(np.uint16).copy()
        self.dv_comp = {k: v.copy() for k, v in self.nmv_comp.items()}

    def eob_flag(self, eob_multi_size: int) -> np.ndarray:
        return getattr(self, f"eob_flag{16 << eob_multi_size}")

    def copy(self) -> "FrameContext":
        out = object.__new__(FrameContext)
        for attr, _, _ in self._SPEC:
            setattr(out, attr, getattr(self, attr).copy())
        out.nmv_comp = {k: v.copy() for k, v in self.nmv_comp.items()}
        out.dv_joints = self.dv_joints.copy()
        out.dv_comp = {k: v.copy() for k, v in self.dv_comp.items()}
        return out

    def inherit_copy(self) -> "FrameContext":
        """Copy for primary_ref_frame inheritance: probabilities carry
        over but every CDF's adaptation counter resets to 0 (spec frame
        init). The counter lives at icdf[nsyms], so tables whose rows use
        fewer symbols than the array width need per-row positions."""
        out = self.copy()
        for attr, _, _ in self._SPEC:
            getattr(out, attr)[..., -1] = 0
        for v in out.nmv_comp.values():
            v[..., -1] = 0
        out.dv_joints[..., -1] = 0
        for v in out.dv_comp.values():
            v[..., -1] = 0
        # palette color-index tables: nsyms = size_idx + 2 per row
        for i in range(7):
            out.palette_y_color[i, :, i + 2] = 0
            out.palette_uv_color[i, :, i + 2] = 0
        # variable-nsyms tables: counter at icdf[nsyms] per row
        out.partition[0:4, 4] = 0          # 8x8 ctxs: 4 symbols
        out.partition[16:20, 8] = 0        # 128x128 ctxs: 8 symbols
        out.partition[4:16, 10] = 0
        out.uv_mode[0, :, 13] = 0          # no-CfL rows: 13 symbols
        out.uv_mode[1, :, 14] = 0
        out.intra_ext_tx[1, :, :, 7] = 0   # set 1: 7 symbols
        out.intra_ext_tx[2, :, :, 5] = 0   # set 2: 5 symbols
        out.inter_ext_tx[1, :, 16] = 0     # ALL16
        out.inter_ext_tx[2, :, 12] = 0     # DTT9_IDTX_1DDCT
        out.inter_ext_tx[3, :, 2] = 0      # DCT_IDTX
        out.tx_size[0, :, 2] = 0           # cat 0: 2 symbols
        out.tx_size[1:, :, 3] = 0
        return out
