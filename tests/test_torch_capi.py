"""The port's C API: native/capi_backend.c built as libsvtav1_torch.so.

The twin of tests/test_capi.py on the port's shim, which
svt_av1_psy_tpu_torch/capi_build.py builds from the reference's own C
source with its two module literals pointed at the port's bridge. It runs
the four cases of the reference's test (lifecycle, bad parameters, a
standalone C program, VBR + TF random access) on the CPU, named with a
staged ``device=cpu`` parameter string, and holds the port's packets to
the reference C API's byte for byte (TF off) or to dav1d against the
port's own recon (TF on). Both shims sit in one process and drive its
interpreter. The standalone C program runs with jax and the JAX package
blocked and loads neither. ``device=cuda``, and the default, fail
svt_tpu_enc_init where there is no GPU.
"""

import ctypes
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch import capi_bridge, capi_build
from svt_av1_psy_tpu_torch.bitstream.ivf import IvfWriter
from svt_av1_psy_tpu_torch.decoder.dav1d import decode_ivf, decode_obus
from svt_av1_psy_tpu_torch.utils.test_clip import make_frame
from test_torch_encode import JAX_BLOCKER

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

SVT_TPU_OK, SVT_TPU_ERROR_BAD_PARAMETER, SVT_TPU_ERROR_RUNTIME = 0, -1, -2


class Cfg(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("bit_depth", ctypes.c_int32), ("enc_mode", ctypes.c_int32),
                ("crf", ctypes.c_double), ("intra_period", ctypes.c_int32),
                ("frame_rate", ctypes.c_int32),
                ("tile_columns", ctypes.c_int32),
                ("hierarchical_levels", ctypes.c_int32),
                ("pred_structure", ctypes.c_int32)]


def _bind(so):
    lib = ctypes.CDLL(str(so))
    lib.svt_tpu_enc_init_handle.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_set_parameter.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_parse_parameter.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
    lib.svt_tpu_enc_init.argtypes = [ctypes.c_void_p]
    lib.svt_tpu_enc_stream_header.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.svt_tpu_enc_send_picture.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32]
    lib.svt_tpu_enc_get_packet.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int64)]
    lib.svt_tpu_enc_deinit.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def lib():
    return _bind(capi_build.build())


@pytest.fixture(scope="module")
def ref_lib():
    from build_capi import build
    return _bind(build())


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Session:
    """One encoder handle of a shim, driven as a C caller drives it."""

    def __init__(self, lib, params=(), **cfg_fields):
        self.lib = lib
        self.h = ctypes.c_void_p()
        cfg = Cfg()
        assert lib.svt_tpu_enc_init_handle(ctypes.byref(self.h),
                                           ctypes.byref(cfg)) == 0
        for k, v in cfg_fields.items():
            setattr(cfg, k, v)
        assert lib.svt_tpu_enc_set_parameter(self.h, ctypes.byref(cfg)) == 0
        for p in params:
            assert lib.svt_tpu_enc_parse_parameter(self.h, p.encode()) == 0
        self.payloads = []

    def init(self) -> int:
        return self.lib.svt_tpu_enc_init(self.h)

    def drain(self):
        data = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_size_t()
        pts = ctypes.c_int64()
        while self.lib.svt_tpu_enc_get_packet(
                self.h, ctypes.byref(data), ctypes.byref(size),
                ctypes.byref(pts)) == 0:
            raw = ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * size.value)).contents
            self.payloads.append((bytes(bytearray(raw)), pts.value))

    def send(self, y, u, v):
        y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
        assert self.lib.svt_tpu_enc_send_picture(
            self.h, y.ctypes.data, y.shape[1], u.ctypes.data, v.ctypes.data,
            u.shape[1]) == 0
        self.drain()

    def flush(self):
        assert self.lib.svt_tpu_enc_send_picture(self.h, None, 0, None,
                                                 None, 0) == 0
        self.drain()

    def close(self):
        self.lib.svt_tpu_enc_deinit(self.h)


LIFECYCLE = dict(width=192, height=128, enc_mode=12, crf=35.0,
                 intra_period=0)


def test_capi_lifecycle(lib, ref_lib):
    """The reference test's lifecycle on the port's shim (device=cpu):
    defaults filled, a stream header, three packets, dav1d decodes them;
    the packets equal the reference C API's on the same frames."""
    frames = [make_frame(192, 128, t, 8, 0.0) for t in range(3)]
    out = {}
    for name, shim, params in (
            ("port", lib, ["enable-variance-boost=1", "device=cpu"]),
            ("ref", ref_lib, ["enable-variance-boost=1"])):
        h = ctypes.c_void_p()
        cfg = Cfg()
        assert shim.svt_tpu_enc_init_handle(ctypes.byref(h),
                                            ctypes.byref(cfg)) == 0
        assert cfg.enc_mode == 8 and cfg.bit_depth == 8   # defaults filled
        shim.svt_tpu_enc_deinit(h)
        s = Session(shim, params, **LIFECYCLE)
        assert s.init() == 0
        data = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_size_t()
        assert shim.svt_tpu_enc_stream_header(s.h, ctypes.byref(data),
                                              ctypes.byref(size)) == 0
        assert size.value > 4
        for f in frames:
            s.send(*f)
        s.flush()
        s.close()
        out[name] = s.payloads
    assert len(out["port"]) == 3
    assert out["port"] == out["ref"]
    buf = io.BytesIO()
    w = IvfWriter(buf, 192, 128)
    for i, (p, _) in enumerate(out["port"]):
        w.write_frame(p, i)
    w.close()
    assert len(decode_ivf(buf.getvalue())) == 3


def test_capi_rejects_bad_params(lib):
    h = ctypes.c_void_p()
    cfg = Cfg()
    assert lib.svt_tpu_enc_init_handle(ctypes.byref(h),
                                       ctypes.byref(cfg)) == 0
    cfg.width, cfg.height = 191, 128          # odd width
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == \
        SVT_TPU_ERROR_BAD_PARAMETER
    cfg.width, cfg.height, cfg.bit_depth = 192, 128, 12
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == \
        SVT_TPU_ERROR_BAD_PARAMETER
    assert lib.svt_tpu_enc_set_parameter(h, None) == \
        SVT_TPU_ERROR_BAD_PARAMETER
    lib.svt_tpu_enc_deinit(h)


def test_both_shims_share_the_interpreter(lib, ref_lib):
    """Both shims loaded into one process (RTLD_LOCAL, the same
    svt_tpu_enc_* symbols) are separate libraries that drive this
    process's interpreter: handles of both, interleaved frame by frame,
    give equal packets; each keeps its own staged parameters."""
    assert lib._handle != ref_lib._handle
    assert capi_build.OUT.parent == ROOT / "svt_av1_psy_tpu_torch" / "_build"
    sessions = [Session(lib, ["device=cpu"], **LIFECYCLE),
                Session(ref_lib, [], **LIFECYCLE)]
    assert [s.init() for s in sessions] == [0, 0]
    for t in range(2):
        for s in sessions:
            s.send(*make_frame(192, 128, t, 8, 0.02,
                               np.random.default_rng(t)))
    for s in sessions:
        s.flush()
        s.close()
    assert len(sessions[0].payloads) == 2
    assert sessions[0].payloads == sessions[1].payloads


@pytest.mark.parametrize("params", [["device=cuda"], [], ["device=cuda:0"]],
                         ids=["cuda", "default", "cuda0"])
def test_capi_cuda_device(lib, params):
    """device=cuda (the default) needs a GPU: without one, init fails
    with SVT_TPU_ERROR_RUNTIME, never encoding on the CPU; "cuda:0" keeps
    its ':' (peeled off before the ':'-separated parameter parse)."""
    s = Session(lib, params, **LIFECYCLE)
    try:
        want = SVT_TPU_OK if torch.cuda.is_available() \
            else SVT_TPU_ERROR_RUNTIME
        assert s.init() == want
    finally:
        s.close()


def test_make_encoder_peels_the_device():
    """The bridge takes a staged device=<name> string out whole before
    parse_parameter_string splits the others on ':'."""
    args = (192, 128, 8, 12, 35.0, 0, 30, -1, 0, 2)
    enc = capi_bridge.make_encoder(
        *args, extra_params=["enable-variance-boost=1:scm=0", "device=cpu"])
    try:
        assert enc.device == torch.device("cpu")
        assert enc.cfg.enable_variance_boost
    finally:
        enc.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda:1"):
            capi_bridge.make_encoder(*args, extra_params=["device=cuda:1"])
        with pytest.raises(RuntimeError, match="cuda"):
            capi_bridge.make_encoder(*args)


_DEMO_C = r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "capi.h"
int main(int argc, char **argv) {
    SvtTpuEncoder *h; SvtTpuConfig cfg;
    if (argc != 2) return 9;
    if (svt_tpu_enc_init_handle(&h, &cfg)) return 1;
    cfg.width = 128; cfg.height = 64; cfg.enc_mode = 12;
    cfg.crf = 40; cfg.intra_period = 0;
    if (svt_tpu_enc_set_parameter(h, &cfg)) return 2;
    if (svt_tpu_enc_parse_parameter(h, "device=cpu")) return 7;
    if (svt_tpu_enc_init(h)) return 3;
    unsigned char *y = malloc(128 * 64), *u = malloc(64 * 32),
                  *v = malloc(64 * 32);
    for (int i = 0; i < 128 * 64; i++) y[i] = (i * 7) & 255;
    memset(u, 128, 64 * 32); memset(v, 100, 64 * 32);
    if (svt_tpu_enc_send_picture(h, y, 128, u, v, 64)) return 4;
    const uint8_t *data; size_t size; int64_t pts;
    if (svt_tpu_enc_get_packet(h, &data, &size, &pts)) return 5;
    FILE *f = fopen(argv[1], "wb");
    if (!f || fwrite(data, 1, size, f) != size) return 8;
    fclose(f);
    printf("packet %zu bytes pts %lld\n", size, (long long)pts);
    svt_tpu_enc_deinit(h);
    return size > 50 ? 0 : 6;
}
'''

# imported by the embedded interpreter at start-up (site): the blocker of
# test_torch_encode.py, writing every blocked import to a file
_SITECUSTOMIZE = JAX_BLOCKER + r'''
import os
open(os.environ["SVT_BLOCK_LOG"], "w").write("installed\n")


class _Log(list):
    def append(self, name):
        super().append(name)
        with open(os.environ["SVT_BLOCK_LOG"], "a") as f:
            f.write(name + "\n")


attempts = _Log()
'''


def test_capi_from_standalone_c_program(lib, tmp_path):
    """A real C program linked against the port's shim: Python starts
    inside the library, imports the port with jax and the JAX package
    blocked, and codes the reference test's frame to the packet the shim
    gives in this process."""
    demo = tmp_path / "demo.c"
    demo.write_text(_DEMO_C)
    exe = tmp_path / "demo"
    subprocess.run(["cc", "-O1", str(demo), "-o", str(exe),
                    f"-I{ROOT / 'native'}", f"-L{capi_build.BUILD}",
                    "-lsvtav1_torch", f"-Wl,-rpath,{capi_build.BUILD}"],
                   check=True)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    log = tmp_path / "blocked.txt"
    # the embedded interpreter finds this interpreter's packages through
    # PYTHONPATH (it starts from the C program, not from a virtualenv)
    env = dict(os.environ, SVT_BLOCK_LOG=str(log), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(site), str(ROOT)] + [p for p in sys.path if p]))
    pkt = tmp_path / "packet.obu"
    r = subprocess.run([str(exe), str(pkt)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-3000:])
    assert "packet" in r.stdout
    assert log.read_text() == "installed\n"
    y = ((np.arange(128 * 64) * 7) & 255).astype(np.uint8).reshape(64, 128)
    u = np.full((32, 64), 128, np.uint8)
    v = np.full((32, 64), 100, np.uint8)
    s = Session(lib, ["device=cpu"], width=128, height=64, enc_mode=12,
                crf=40.0, intra_period=0)
    assert s.init() == 0
    s.send(y, u, v)
    s.close()
    assert [p for p, _ in s.payloads] == [pkt.read_bytes()]


def test_capi_vbr_tf_random_access(lib):
    """Library-level RC + TF + TPL through the port's shim: a VBR
    random-access encode driven by parameter strings alone. The packets
    equal the port's API run of the same config, whose recon dav1d gives
    back exactly; the rate lands near the target, as in the reference
    test."""
    params = ["rc=1:tbr=200:enable-tf=1:enable-tpl-la=1", "device=cpu"]
    cfg = dict(width=192, height=128, enc_mode=8, crf=35.0,
               intra_period=-1, hierarchical_levels=2, pred_structure=2)
    s = Session(lib, params, **cfg)
    assert s.init() == 0
    n = 13
    frames = [make_frame(192, 128, t, 8, 0.02) for t in range(n)]
    for f in frames:
        s.send(*f)
    s.flush()
    s.close()
    api = capi_bridge.make_encoder(192, 128, 8, 8, 35.0, -1, 30, -1, 2, 2,
                                   extra_params=params)
    try:
        pkts = [p for f in frames for p in api.send_picture(*f)] + \
            api.flush()
    finally:
        api.close()
    assert api._ra is not None and api._ra.tf_strength
    assert [(p.payload, p.display_idx) for p in pkts] == s.payloads
    shown = [p for p in pkts if p.display_idx >= 0]
    assert len(shown) == n
    dec = decode_obus(b"".join(p for p, _ in s.payloads))
    assert len(dec) == n
    by_disp = {p.display_idx: p.recon for p in shown}
    for i, d in enumerate(dec):
        for plane, rec in zip((d.y, d.u, d.v), by_disp[i]):
            assert np.array_equal(plane, rec), i
    kbps = sum(len(p) for p, _ in s.payloads) * 8 * 30 / n / 1000
    assert 40 < kbps < 600, kbps
