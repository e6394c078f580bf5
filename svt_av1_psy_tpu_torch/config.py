"""Encoder configuration: the single schema behind the API, the CLI and key=value parsing.

Mirrors the reference's three coordinated config layers (SURVEY.md §5):
  - struct `EbSvtAv1EncConfiguration` (ref: Source/API/EbSvtAv1Enc.h:219-1063)
  - defaults `svt_av1_set_default_params` (ref: Source/Lib/Globals/enc_settings.c:948-1111)
  - validation `svt_av1_verify_settings` + string parser `svt_av1_enc_parse_parameter`
    (ref: Source/Lib/Globals/enc_settings.c:239-947, 2089-2260)
  - documented ranges: ref Docs/Parameters.md:16-367

Field names and semantics are kept identical to the reference so that a user of
`--svtav1-params` / the FFmpeg plugin can move over without relearning anything.
The *implementation* is a plain Python dataclass — no handle/ctor machinery; the
TPU encoder is functional and the config is immutable once the Encoder is built.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

# Sentinel matching the reference's DEFAULT (-1) "derive from preset/inputs".
DEFAULT = -1

MAX_TEMPORAL_LAYERS = 6
FRAME_UPDATE_TYPES = 7  # KF, LF, GF, ARF, OVERLAY, INTNL_OVERLAY, INTNL_ARF

MIN_QP_VALUE = 0
MAX_QP_VALUE = 63
MAX_QINDEX = 255
DEFAULT_QP = 35


class RateControlMode(IntEnum):
    """ref: EbSvtAv1Enc.h SVT_AV1_RC_MODE_* (0=CQP/CRF, 1=VBR, 2=CBR)."""

    CQP_OR_CRF = 0
    VBR = 1
    CBR = 2


class PredStructure(IntEnum):
    """ref: EbSvtAv1Enc.h SVT_AV1_PRED_* (low-delay B / random access)."""

    LOW_DELAY_B = 1
    RANDOM_ACCESS = 2


class IntraRefreshType(IntEnum):
    """ref: EbSvtAv1Enc.h SvtAv1IntraRefreshType."""

    FWDKF = 1  # open GOP, forward key frame (CRA)
    KF = 2  # closed GOP, key frame (IDR)


class ColorFormat(IntEnum):
    """ref: EbSvtAv1Formats.h EbColorFormat."""

    YUV400 = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3


class Tune(IntEnum):
    """ref: Docs/Parameters.md --tune [0-4]."""

    VQ = 0
    PSNR = 1
    SSIM = 2
    SSIM_SUBJECTIVE = 3  # PSY Tune 3 "Subjective SSIM"
    STILL_PICTURE = 4  # PSY Tune 4


class SuperresMode(IntEnum):
    NONE = 0
    FIXED = 1
    RANDOM = 2
    QTHRESH = 3
    AUTO = 4


class ResizeMode(IntEnum):
    NONE = 0
    FIXED = 1
    RANDOM = 2
    DYNAMIC = 3
    RANDOM_ACCESS_EVENT = 4


class SframeMode(IntEnum):
    STRICT_BASE = 1
    NEAREST_BASE = 2


@dataclass
class EncoderConfig:
    """Full encoder configuration (every field of EbSvtAv1EncConfiguration).

    Defaults mirror svt_av1_set_default_params (enc_settings.c:948-1111) with the
    PSY fork's defaults (sharpness=1, qp_scale_compress_strength=1, tune=2,
    variance boost on, adaptive film grain on).
    """

    # --- Preset / structure -------------------------------------------------
    enc_mode: int = 10  # preset, -2..13 (-2/-1 debug)
    intra_period_length: int = -2  # -2: auto from fps; -1: infinite GOP
    intra_refresh_type: IntraRefreshType = IntraRefreshType.KF
    hierarchical_levels: int = 0  # 0 = auto (preset-derived); 2..5 = 3..6 layers
    pred_structure: PredStructure = PredStructure.RANDOM_ACCESS
    force_key_frames: bool = False
    multiply_keyint: bool = False
    startup_mg_size: int = 0  # 0 = same as mini-GoP size; else 2/3/4
    sframe_dist: int = 0
    sframe_mode: SframeMode = SframeMode.NEAREST_BASE
    enable_dg: bool = True  # dynamic mini-GoP

    # --- Input description ---------------------------------------------------
    source_width: int = 0
    source_height: int = 0
    forced_max_frame_width: int = 0
    forced_max_frame_height: int = 0
    frame_rate_numerator: int = 60000
    frame_rate_denominator: int = 1000
    encoder_bit_depth: int = 10
    encoder_color_format: ColorFormat = ColorFormat.YUV420
    high_dynamic_range_input: bool = False

    # --- Annex A / color description -----------------------------------------
    profile: int = 0  # 0 main, 1 high, 2 professional
    tier: int = 0
    level: int = 0  # 0 = auto; else level*10 (e.g. 5.1 -> 51)
    color_description_present_flag: bool = False
    color_primaries: int = 2  # CP_UNSPECIFIED
    transfer_characteristics: int = 2  # TC_UNSPECIFIED
    matrix_coefficients: int = 2  # MC_UNSPECIFIED
    color_range: int = 0  # 0 studio, 1 full
    chroma_sample_position: int = 0  # CSP_UNKNOWN
    mastering_display: Optional[str] = None  # "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)"
    content_light_level: Optional[str] = None  # "max_cll,max_fall"

    # --- Rate control ---------------------------------------------------------
    rate_control_mode: RateControlMode = RateControlMode.CQP_OR_CRF
    qp: int = DEFAULT_QP
    use_qp_file: bool = False
    target_bit_rate: int = 2000513  # bps
    max_bit_rate: int = 0
    vbv_bufsize: int = 0
    max_qp_allowed: int = 63
    min_qp_allowed: int = 4
    vbr_bias_pct: int = 100
    vbr_min_section_pct: int = 0
    vbr_max_section_pct: int = 2000
    under_shoot_pct: int = DEFAULT
    over_shoot_pct: int = DEFAULT
    mbr_over_shoot_pct: int = 50
    starting_buffer_level_ms: int = 600
    optimal_buffer_level_ms: int = 600
    maximum_buffer_size_ms: int = 1000
    recode_loop: int = 4  # ALLOW_RECODE_DEFAULT
    gop_constraint_rc: bool = False
    pass_num: int = 0  # `pass` is a keyword; exposed as "pass" in parse/CLI
    rc_stats_file: Optional[str] = None  # 2-pass stats path (app-level in ref)

    # --- Fixed qindex offsets ---------------------------------------------------
    use_fixed_qindex_offsets: int = 0  # 0/1/2
    qindex_offsets: tuple = (0,) * MAX_TEMPORAL_LAYERS
    key_frame_qindex_offset: int = 0
    key_frame_chroma_qindex_offset: int = 0
    chroma_qindex_offsets: tuple = (0,) * MAX_TEMPORAL_LAYERS
    luma_y_dc_qindex_offset: int = 0
    chroma_u_dc_qindex_offset: int = 0
    chroma_u_ac_qindex_offset: int = 0
    chroma_v_dc_qindex_offset: int = 0
    chroma_v_ac_qindex_offset: int = 0
    lambda_scale_factors: tuple = (128,) * FRAME_UPDATE_TYPES

    # --- Quantization matrices ----------------------------------------------
    enable_qm: bool = True
    min_qm_level: int = 0
    max_qm_level: int = 15
    # PSY: chroma QM range decoupled from luma (README.md:71-74)
    min_chroma_qm_level: int = 8
    max_chroma_qm_level: int = 15

    # --- Adaptive quantization / PSY rate-control features --------------------
    enable_adaptive_quantization: int = 2  # 0 off, 1 segments, 2 deltaq
    # PSY variance-boost AQ (ref: rc_process.c:1407-1620, Appendix-Variance-Boost.md)
    enable_variance_boost: bool = True
    variance_boost_strength: int = 2  # 1..4
    variance_octile: int = 6  # 1..8
    enable_alt_curve: bool = False
    # PSY extended CRF: effective CRF = qp + extended_crf_qindex_offset/4, up to 70
    extended_crf_qindex_offset: int = 0
    # PSY qp-scale-compress (ref: rc_process.c:777-880)
    qp_scale_compress_strength: int = 1  # 0..3
    # PSY frame-luma-bias (ref: rc_process.c:3413-3414)
    frame_luma_bias: int = 0  # 0..100
    enable_roi_map: bool = False
    roi_map_file: Optional[str] = None

    # --- PSY psychovisual tools ------------------------------------------------
    tune: Tune = Tune.SSIM
    # psy-rd strength 0.0..6.0; needs tune >= 2 (ref: enc_settings.c:932-940)
    psy_rd: float = 0.0
    # sharpness -7..7: quant rounding + DLF bias (ref: md_config_process.c:96-117)
    sharpness: int = 1
    # noise normalization: AC coefficient boost (ref: full_loop.c:1464)
    noise_norm_strength: int = 0  # 0..4; auto 3 at tune 3
    # restrict transform sizes to <=32x32 (README.md:67-69)
    max_32_tx_size: bool = False

    # --- Temporal filtering (alt-ref) ----------------------------------------
    enable_tf: int = 1  # 0 off, 1 on, 2 adaptive per-64x64 error
    enable_overlays: bool = False
    tf_strength: int = 1  # 0..4 (PSY: 4x weaker scaling than mainline)
    kf_tf_strength: int = 1  # 0..4

    # --- Film grain -----------------------------------------------------------
    film_grain_denoise_strength: int = 0  # 0..50
    film_grain_denoise_apply: bool = False
    adaptive_film_grain: bool = True  # PSY: grain block size 32 vs 64 by resolution
    fgs_table: Optional[str] = None  # external film-grain table path

    # --- In-loop filters --------------------------------------------------------
    enable_dlf_flag: int = 1  # 0 off, 1 on, 2 slower/exact luma filter
    cdef_level: int = DEFAULT  # -1 auto, 0 off, 1..4 search levels
    enable_restoration_filtering: int = DEFAULT  # -1 auto, 0 off, 1 on

    # --- Motion / prediction tools ---------------------------------------------
    enable_mfmv: int = DEFAULT
    restricted_motion_vector: bool = False
    scene_change_detection: int = 0
    screen_content_mode: int = 2  # 0 off, 1 on, 2 content-based detection
    enable_tpl_la: int = 1
    look_ahead_distance: int = DEFAULT  # (uint32)~0 in ref == auto

    # --- Tiles -------------------------------------------------------------------
    tile_columns: int = DEFAULT  # log2
    tile_rows: int = DEFAULT  # log2

    # --- Super-resolution / reference scaling -----------------------------------
    superres_mode: SuperresMode = SuperresMode.NONE
    superres_denom: int = 8
    superres_kf_denom: int = 8
    superres_qthres: int = 43
    superres_kf_qthres: int = 43
    superres_auto_search_type: int = 0
    resize_mode: ResizeMode = ResizeMode.NONE
    resize_denom: int = 8
    resize_kf_denom: int = 8
    frame_scale_evts: tuple = ()  # ((start_frame, resize_denom, resize_kf_denom), ...)

    # --- Manual prediction structure ---------------------------------------------
    enable_manual_pred_struct: bool = False
    manual_pred_struct: tuple = ()  # ((decode_order, temporal_layer, ref_list...), ...)

    # --- Decode-speed oriented ----------------------------------------------------
    fast_decode: int = 0  # 0..2

    # --- Platform / parallelism (TPU semantics; names kept for compat) ------------
    channel_id: int = 0
    active_channel_count: int = 1
    # On TPU these size the host pipeline + device mesh instead of thread pools:
    level_of_parallelism: int = 0  # 0 auto; 1..6 frames-in-flight scaling
    logical_processors: int = 0
    pin_threads: int = 0
    target_socket: int = -1
    use_cpu_flags: int = ~0 & 0xFFFFFFFF  # kept for API compat; no RTCD on TPU

    # --- Output / debug -------------------------------------------------------------
    stat_report: int = 0
    recon_enabled: bool = False

    # ------------------------------------------------------------------
    @property
    def crf(self) -> float:
        """Extended CRF = qp + extended_crf_qindex_offset/4 (enc_settings.c:1128)."""
        return float(self.qp) + self.extended_crf_qindex_offset / 4.0

    def with_crf(self, crf: float) -> "EncoderConfig":
        """Set CRF in quarter steps; values >63 use the extended-CRF qindex offset."""
        qp = int(crf)
        frac_offset = int(round((crf - qp) * 4))
        return dataclasses.replace(
            self,
            qp=min(qp, MAX_QP_VALUE),
            extended_crf_qindex_offset=(
                frac_offset + max(0, qp - MAX_QP_VALUE) * 4
            ),
            rate_control_mode=RateControlMode.CQP_OR_CRF,
            enable_adaptive_quantization=2,
        )

    @property
    def frame_rate(self) -> float:
        return self.frame_rate_numerator / max(1, self.frame_rate_denominator)

    def replace(self, **kw) -> "EncoderConfig":
        return dataclasses.replace(self, **kw)


class ConfigError(ValueError):
    """Equivalent of EB_ErrorBadParameter from svt_av1_verify_settings."""


def _check(cond: bool, msg: str, errors: list):
    if not cond:
        errors.append(msg)


def validate_config(cfg: EncoderConfig) -> EncoderConfig:
    """Range/conflict validation mirroring svt_av1_verify_settings (enc_settings.c:239-947).

    Returns the config (for chaining); raises ConfigError listing every violation.
    """
    e: list = []
    _check(-2 <= cfg.enc_mode <= 13, f"preset {cfg.enc_mode} out of [-2..13]", e)
    _check(
        cfg.source_width == 0 or 64 <= cfg.source_width <= 16384,
        f"source_width {cfg.source_width} out of [64..16384]", e)
    _check(
        cfg.source_height == 0 or 64 <= cfg.source_height <= 8704,
        f"source_height {cfg.source_height} out of [64..8704]", e)
    _check(cfg.source_width % 2 == 0 and cfg.source_height % 2 == 0,
           "width/height must be even", e)
    _check(cfg.encoder_bit_depth in (8, 10), f"bit depth {cfg.encoder_bit_depth} not in (8,10)", e)
    _check(cfg.encoder_color_format == ColorFormat.YUV420,
           "only YUV420 is supported (matches reference)", e)
    _check(0 <= cfg.qp <= MAX_QP_VALUE, f"qp {cfg.qp} out of [0..63]", e)
    _check(cfg.crf <= 70.0, f"extended CRF {cfg.crf} > 70", e)
    _check(cfg.rate_control_mode in tuple(RateControlMode), "bad rc mode", e)
    _check(0 <= cfg.tune <= 4, f"tune {cfg.tune} out of [0..4]", e)
    _check(0.0 <= cfg.psy_rd <= 6.0, f"psy_rd {cfg.psy_rd} out of [0.0..6.0]", e)
    if cfg.psy_rd != 0.0:
        _check(cfg.tune >= 2, "psy_rd requires tune >= 2 (enc_settings.c:937)", e)
    _check(-7 <= cfg.sharpness <= 7, f"sharpness {cfg.sharpness} out of [-7..7]", e)
    _check(0 <= cfg.noise_norm_strength <= 4, "noise_norm_strength out of [0..4]", e)
    _check(0 <= cfg.tf_strength <= 4, "tf_strength out of [0..4]", e)
    _check(0 <= cfg.kf_tf_strength <= 4, "kf_tf_strength out of [0..4]", e)
    _check(1 <= cfg.variance_boost_strength <= 4, "variance_boost_strength out of [1..4]", e)
    _check(1 <= cfg.variance_octile <= 8, "variance_octile out of [1..8]", e)
    _check(0 <= cfg.qp_scale_compress_strength <= 3, "qp_scale_compress_strength out of [0..3]", e)
    _check(0 <= cfg.frame_luma_bias <= 100, "frame_luma_bias out of [0..100]", e)
    _check(0 <= cfg.min_qm_level <= cfg.max_qm_level <= 15, "bad QM level range", e)
    _check(0 <= cfg.min_chroma_qm_level <= cfg.max_chroma_qm_level <= 15,
           "bad chroma QM level range", e)
    _check(cfg.hierarchical_levels in (0, 2, 3, 4, 5), "hierarchical_levels must be 0 or 2..5", e)
    _check(cfg.tile_columns == DEFAULT or 0 <= cfg.tile_columns <= 6, "tile_columns log2 out of range", e)
    _check(cfg.tile_rows == DEFAULT or 0 <= cfg.tile_rows <= 6, "tile_rows log2 out of range", e)
    _check(0 <= cfg.fast_decode <= 2, "fast_decode out of [0..2]", e)
    _check(0 <= cfg.enable_tf <= 2, "enable_tf out of [0..2]", e)
    _check(0 <= cfg.enable_dlf_flag <= 2, "enable_dlf out of [0..2]", e)
    _check(cfg.cdef_level == DEFAULT or 0 <= cfg.cdef_level <= 4, "cdef_level out of range", e)
    _check(0 <= cfg.enable_adaptive_quantization <= 2, "aq-mode out of [0..2]", e)
    _check(0 <= cfg.screen_content_mode <= 2, "scm out of [0..2]", e)
    _check(cfg.film_grain_denoise_strength <= 50, "film-grain strength out of [0..50]", e)
    _check(0 <= cfg.pass_num <= 2, "pass out of [0..2]", e)
    _check(cfg.min_qp_allowed < cfg.max_qp_allowed <= 63, "bad min/max qp range", e)
    _check(0 <= cfg.level_of_parallelism <= 6, "lp out of [0..6]", e)
    if cfg.rate_control_mode == RateControlMode.VBR:
        _check(cfg.pred_structure == PredStructure.RANDOM_ACCESS,
               "VBR requires random-access pred structure", e)
    if cfg.rate_control_mode != RateControlMode.CQP_OR_CRF:
        _check(1 <= cfg.target_bit_rate <= 100_000_000, "target_bit_rate out of range", e)
    if e:
        raise ConfigError("; ".join(e))
    return cfg


# ---------------------------------------------------------------------------
# key=value parameter parsing (the library-side flag system used by
# --svtav1-params and the FFmpeg plugin).
# Token names mirror svt_av1_enc_parse_parameter (enc_settings.c:2089-2260).
# ---------------------------------------------------------------------------

_INT_PARAMS = {
    "w": "source_width", "width": "source_width",
    "h": "source_height", "height": "source_height",
    "q": "qp", "qp": "qp",
    "film-grain": "film_grain_denoise_strength",
    "hierarchical-levels": "hierarchical_levels",
    "tier": "tier",
    "lp": "level_of_parallelism",
    "pin": "pin_threads",
    "fps-num": "frame_rate_numerator",
    "fps-denom": "frame_rate_denominator",
    "lookahead": "look_ahead_distance",
    "scd": "scene_change_detection",
    "max-qp": "max_qp_allowed",
    "min-qp": "min_qp_allowed",
    "bias-pct": "vbr_bias_pct",
    "minsection-pct": "vbr_min_section_pct",
    "maxsection-pct": "vbr_max_section_pct",
    "undershoot-pct": "under_shoot_pct",
    "overshoot-pct": "over_shoot_pct",
    "mbr-overshoot-pct": "mbr_over_shoot_pct",
    "recode-loop": "recode_loop",
    "enable-stat-report": "stat_report",
    "scm": "screen_content_mode",
    "input-depth": "encoder_bit_depth",
    "forced-max-frame-width": "forced_max_frame_width",
    "forced-max-frame-height": "forced_max_frame_height",
    "pred-struct": "pred_structure",
    "enable-tpl-la": "enable_tpl_la",
    "aq-mode": "enable_adaptive_quantization",
    "superres-mode": "superres_mode",
    "superres-qthres": "superres_qthres",
    "superres-kf-qthres": "superres_kf_qthres",
    "superres-denom": "superres_denom",
    "superres-kf-denom": "superres_kf_denom",
    "tune": "tune",
    "enable-hdr": "high_dynamic_range_input",
    "enable-dlf": "enable_dlf_flag",
    "resize-mode": "resize_mode",
    "resize-denom": "resize_denom",
    "resize-kf-denom": "resize_kf_denom",
    "qm-min": "min_qm_level",
    "qm-max": "max_qm_level",
    "chroma-qm-min": "min_chroma_qm_level",
    "chroma-qm-max": "max_chroma_qm_level",
    "use-fixed-qindex-offsets": "use_fixed_qindex_offsets",
    "startup-mg-size": "startup_mg_size",
    "variance-boost-strength": "variance_boost_strength",
    "variance-octile": "variance_octile",
    "qp-scale-compress-strength": "qp_scale_compress_strength",
    "frame-luma-bias": "frame_luma_bias",
    "tf-strength": "tf_strength",
    "kf-tf-strength": "kf_tf_strength",
    "noise-norm-strength": "noise_norm_strength",
    "fast-decode": "fast_decode",
    "enable-tf": "enable_tf",
    "buf-initial-sz": "starting_buffer_level_ms",
    "buf-optimal-sz": "optimal_buffer_level_ms",
    "buf-sz": "maximum_buffer_size_ms",
    "key-frame-chroma-qindex-offset": "key_frame_chroma_qindex_offset",
    "key-frame-qindex-offset": "key_frame_qindex_offset",
    "luma-y-dc-qindex-offset": "luma_y_dc_qindex_offset",
    "chroma-u-dc-qindex-offset": "chroma_u_dc_qindex_offset",
    "chroma-u-ac-qindex-offset": "chroma_u_ac_qindex_offset",
    "chroma-v-dc-qindex-offset": "chroma_v_dc_qindex_offset",
    "chroma-v-ac-qindex-offset": "chroma_v_ac_qindex_offset",
    "pass": "pass_num",
    "enable-cdef": "cdef_level",
    "enable-restoration": "enable_restoration_filtering",
    "enable-mfmv": "enable_mfmv",
    "intra-period": "intra_period_length",
    "keyint": "intra_period_length",  # keyint = intra-period + 1 handled below
    "tile-rows": "tile_rows",
    "tile-columns": "tile_columns",
    "ss": "target_socket",
    "sframe-dist": "sframe_dist",
    "preset": "enc_mode",
    "sharpness": "sharpness",
    "level": "level",
    "color-primaries": "color_primaries",
    "transfer-characteristics": "transfer_characteristics",
    "matrix-coefficients": "matrix_coefficients",
    "chroma-sample-position": "chroma_sample_position",
    "color-range": "color_range",
    "sframe-mode": "sframe_mode",
}

_BOOL_PARAMS = {
    "use-q-file": "use_qp_file",
    "enable-overlays": "enable_overlays",
    "enable-qm": "enable_qm",
    "enable-variance-boost": "enable_variance_boost",
    "enable-alt-curve": "enable_alt_curve",
    "max-32-tx-size": "max_32_tx_size",
    "adaptive-film-grain": "adaptive_film_grain",
    "enable-dg": "enable_dg",
    "fast": "fast_decode",
    "force-key-frames": "force_key_frames",
    "multiply-keyint": "multiply_keyint",
    "gop-constraint-rc": "gop_constraint_rc",
    "enable-force-key-frames": "force_key_frames",
    "film-grain-denoise": "film_grain_denoise_apply",
    "enable-roi-map": "enable_roi_map",
    "rmv": "restricted_motion_vector",
    "enable-dlf-bool": "enable_dlf_flag",
    "color-description-present": "color_description_present_flag",
}

_FLOAT_PARAMS = {"psy-rd": "psy_rd"}

_STR_PARAMS = {
    "fgs-table": "fgs_table",
    "roi-map-file": "roi_map_file",
    "mastering-display": "mastering_display",
    "content-light": "content_light_level",
    "stats": "rc_stats_file",
}

_RC_NAMES = {"cqp": 0, "crf": 0, "vbr": 1, "cbr": 2}
_PROFILE_NAMES = {"main": 0, "high": 1, "professional": 2}
_IREFRESH_NAMES = {"cra": 1, "fwdkf": 1, "idr": 2, "kf": 2}
_COLOR_FMT_NAMES = {"mono": 0, "400": 0, "420": 1, "422": 2, "444": 3}
_COLOR_RANGE_NAMES = {"studio": 0, "full": 1}


def _parse_bitrate(v: str) -> int:
    """Accept b/k/m suffixes like the reference's str_to_* bitrate parsing."""
    v = v.strip().lower()
    mult = 1000  # bare numbers are kbps at the app level
    if v.endswith("b"):
        v, mult = v[:-1], 1
    elif v.endswith("k"):
        v, mult = v[:-1], 1000
    elif v.endswith("m"):
        v, mult = v[:-1], 1_000_000
    return int(float(v) * mult)


def parse_parameter(cfg: EncoderConfig, name: str, value: str) -> EncoderConfig:
    """svt_av1_enc_parse_parameter equivalent: apply one key=value to a config.

    Raises ConfigError for unknown names or unparseable values.
    """
    name = name.strip().lstrip("-")
    value = value.strip()
    try:
        if name == "crf":
            return cfg.with_crf(float(value))
        if name == "rc":
            mode = _RC_NAMES.get(value.lower())
            if mode is None:
                mode = int(value)
            return cfg.replace(rate_control_mode=RateControlMode(mode))
        if name in ("tbr", "target-bit-rate"):
            return cfg.replace(target_bit_rate=_parse_bitrate(value))
        if name in ("mbr", "max-bit-rate"):
            return cfg.replace(max_bit_rate=_parse_bitrate(value))
        if name == "profile":
            return cfg.replace(profile=_PROFILE_NAMES.get(value.lower(), None)
                               if value.lower() in _PROFILE_NAMES else int(value))
        if name == "irefresh-type":
            v = _IREFRESH_NAMES.get(value.lower())
            return cfg.replace(intra_refresh_type=IntraRefreshType(v if v else int(value)))
        if name == "color-format":
            v = _COLOR_FMT_NAMES.get(value.lower())
            return cfg.replace(encoder_color_format=ColorFormat(v if v is not None else int(value)))
        if name == "color-range":
            v = _COLOR_RANGE_NAMES.get(value.lower())
            return cfg.replace(color_range=v if v is not None else int(value))
        if name == "keyint":
            # keyint N == intra-period N-1; -1 means infinite (matches app semantics)
            n = int(value)
            return cfg.replace(intra_period_length=n - 1 if n > 0 else n)
        if name == "qindex-offsets":
            vals = tuple(int(x) for x in value.strip("[]").split(","))
            return cfg.replace(qindex_offsets=vals)
        if name == "chroma-qindex-offsets":
            vals = tuple(int(x) for x in value.strip("[]").split(","))
            return cfg.replace(chroma_qindex_offsets=vals)
        if name == "lambda-scale-factors":
            vals = tuple(int(x) for x in value.strip("[]").split(","))
            return cfg.replace(lambda_scale_factors=vals)
        if name == "fps":
            return cfg.replace(frame_rate_numerator=int(value) * 1000,
                               frame_rate_denominator=1000)
        if name in _FLOAT_PARAMS:
            return cfg.replace(**{_FLOAT_PARAMS[name]: float(value)})
        if name in _STR_PARAMS:
            return cfg.replace(**{_STR_PARAMS[name]: value})
        if name in _BOOL_PARAMS:
            fname = _BOOL_PARAMS[name]
            v = value.lower() in ("1", "true", "yes", "on")
            cur = getattr(cfg, fname)
            return cfg.replace(**{fname: type(cur)(v) if not isinstance(cur, bool) else v})
        if name in _INT_PARAMS:
            fname = _INT_PARAMS[name]
            cur = getattr(cfg, fname)
            v = int(value)
            if isinstance(cur, IntEnum):
                v = type(cur)(v)
            elif isinstance(cur, bool):
                v = bool(v)
            return cfg.replace(**{fname: v})
    except ConfigError:
        raise
    except (ValueError, KeyError) as exc:
        raise ConfigError(f"bad value {value!r} for parameter {name!r}: {exc}") from exc
    raise ConfigError(f"unknown parameter {name!r}")


def parse_parameter_string(cfg: EncoderConfig, params: str) -> EncoderConfig:
    """Parse a `key=value:key=value` string (the --svtav1-params format)."""
    for tok in params.split(":"):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ConfigError(f"malformed parameter token {tok!r} (expected key=value)")
        k, v = tok.split("=", 1)
        cfg = parse_parameter(cfg, k, v)
    return cfg


# ---------------------------------------------------------------------------
# Derived (post-validation) settings — mirrors set_param_based_on_input +
# pieces of load_default_buffer_configuration_settings (enc_handle.c:734-1100),
# re-targeted at TPU pipeline sizing rather than thread pools.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DerivedSettings:
    sb_size: int
    superblock_cols: int
    superblock_rows: int
    intra_period: int
    hierarchical_levels: int
    mini_gop_size: int
    tile_cols_log2: int
    tile_rows_log2: int
    lookahead: int
    frames_in_flight: int
    base_qindex: int
    bit_depth: int


def qp_to_qindex(qp: float) -> int:
    """CRF/QP → qindex. The AV1 qindex grid is 4x finer than the 0-63 QP scale."""
    return int(round(qp * 4))


def derive_settings(cfg: EncoderConfig) -> DerivedSettings:
    """Resolve every DEFAULT/auto field into concrete values."""
    # SB size: 128 for slow presets at high res in the reference; start with 64
    # (preset >= 4 uses 64x64 in the reference's preset table, CommonQuestions.md).
    sb = 128 if cfg.enc_mode <= 1 and cfg.source_width * cfg.source_height > 1920 * 1080 else 64
    cols = (cfg.source_width + sb - 1) // sb
    rows = (cfg.source_height + sb - 1) // sb

    if cfg.hierarchical_levels == 0:
        hl = 5 if cfg.enc_mode <= 12 else 4
    else:
        hl = cfg.hierarchical_levels
    mini_gop = 1 << hl

    if cfg.intra_period_length == -2:
        # auto: ~5 seconds of video, rounded to mini-GoP multiple (pd_process behavior)
        ip = int(cfg.frame_rate * 5)
        ip = ((ip + mini_gop - 1) // mini_gop) * mini_gop - 1
    else:
        ip = cfg.intra_period_length

    if cfg.tile_columns == DEFAULT:
        # auto-tiling: aim for ~2 tiles at 1080p, 8 at 4K (TPU: tiles are shard axes)
        tc = max(0, int(math.log2(max(1, cfg.source_width // 1920))))
    else:
        tc = cfg.tile_columns
    tr = max(0, cfg.tile_rows) if cfg.tile_rows != DEFAULT else 0

    la = cfg.look_ahead_distance
    if la == DEFAULT or la == 0xFFFFFFFF:
        la = min(120, 2 * mini_gop + 1) if cfg.enable_tpl_la else 0

    lp = cfg.level_of_parallelism or 4
    frames_in_flight = (1 + mini_gop) * min(lp, 6)

    return DerivedSettings(
        sb_size=sb,
        superblock_cols=cols,
        superblock_rows=rows,
        intra_period=ip,
        hierarchical_levels=hl,
        mini_gop_size=mini_gop,
        tile_cols_log2=tc,
        tile_rows_log2=tr,
        lookahead=la,
        frames_in_flight=frames_in_flight,
        base_qindex=min(255, qp_to_qindex(cfg.crf)),
        bit_depth=cfg.encoder_bit_depth,
    )
