"""Build libsvtav1_torch.so, the port's C API library (native/capi.h).

The port's twin of tools/build_capi.py. The shim is the reference's own
source, native/capi_backend.c, which names the Python module it drives in
two string literals; this builder reads it, points both at the port's
bridge (svt_av1_psy_tpu_torch.capi_bridge) and fails unless exactly two
were replaced, so the C source stays the one piece of code the two
packages share. The patched source and the library are written under
svt_av1_psy_tpu_torch/_build/ (never into native/), compiled with
``-I native/`` against the running interpreter's libpython, and kept
while a digest of the patched source, the header and that interpreter
matches its stamp. The build goes to names of this process's own that are
then renamed into place, so several processes may build at once.

    python -m svt_av1_psy_tpu_torch.capi_build [--force]

prints the library's path. A C caller links it as it links the
reference's libsvtav1_tpu.so and picks the device with a staged parameter
string, ``svt_tpu_enc_parse_parameter(h, "device=cuda")`` (the default).
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import sysconfig

_PKG = pathlib.Path(__file__).resolve().parent
NATIVE = _PKG.parent / "native"
SRC = NATIVE / "capi_backend.c"
HDR = NATIVE / "capi.h"
BUILD = _PKG / "_build"
PATCHED = BUILD / "capi_backend_torch.c"
OUT = BUILD / "libsvtav1_torch.so"
STAMP = BUILD / "libsvtav1_torch.hash"

PORT_MODULE = '"svt_av1_psy_tpu_torch.capi_bridge"'
# the reference's bridge: the same name without the port's suffix (this
# package names no module of the reference in a literal)
REF_MODULE = PORT_MODULE.replace("_torch.", ".")


def patched_source() -> str:
    """native/capi_backend.c with both module literals pointed at the
    port's bridge."""
    src = SRC.read_text()
    n = src.count(REF_MODULE)
    if n != 2:
        raise RuntimeError(f"{SRC} names {REF_MODULE} {n} times, not 2: "
                           "the shim changed, check what the port patches")
    return src.replace(REF_MODULE, PORT_MODULE)


def _python_flags() -> list:
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-I{sysconfig.get_path('include')}", f"-L{libdir}", f"-l{ver}",
            f"-Wl,-rpath,{libdir}"]


def build(force: bool = False) -> pathlib.Path:
    text = patched_source()
    flags = _python_flags()
    digest = hashlib.sha256("\0".join(
        [text, HDR.read_text()] + flags).encode()).hexdigest()
    if not force and OUT.exists() and STAMP.exists() and \
            STAMP.read_text() == digest:
        return OUT
    BUILD.mkdir(exist_ok=True)
    pid = os.getpid()
    src_tmp = PATCHED.with_name(f"{PATCHED.name}.{pid}.tmp.c")
    out_tmp = OUT.with_name(f"{OUT.name}.{pid}.tmp")
    src_tmp.write_text(text)
    try:
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", str(src_tmp), "-o",
                        str(out_tmp), f"-I{NATIVE}"] + flags, check=True)
    except BaseException:
        src_tmp.unlink(missing_ok=True)
        out_tmp.unlink(missing_ok=True)
        raise
    os.replace(src_tmp, PATCHED)
    os.replace(out_tmp, OUT)
    stamp_tmp = STAMP.with_name(f"{STAMP.name}.{pid}.tmp")
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, STAMP)
    return OUT


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
