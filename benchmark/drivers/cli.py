"""Drives the command (svt_av1_psy_tpu_torch.app.cli.main) as users run
it: a y4m stream into a named pipe, an IVF file out, both in a directory
of their own under TMPDIR.

The command runs in this thread; a second thread writes frames into the
pipe as fast as the command reads them (a closed loop). A frame counts
when the command writes its packet to the IVF. Set-up ends when the
traffic's warm-up count of frames has been written (the key frame with
its host temporal filter, and a few P frames). The window counts the
frames written inside it and their payload bytes. A harness span times
each of the command's lookahead calls (tpl_sb_offsets).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading


def _header(w: int, h: int, bd: int) -> bytes:
    cs = "C420jpeg" if bd == 8 else f"C420p{bd}"
    return f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 {cs}\n".encode()


def drive(ctx) -> None:
    import svt_av1_psy_tpu_torch.bitstream.ivf as ivf_mod
    import svt_av1_psy_tpu_torch.models.tpl as tpl_mod
    from svt_av1_psy_tpu_torch.app import cli

    c = ctx.config
    warm = int(ctx.traffic["warmup"]["ld_frames"])
    ctx.wrap_span(tpl_mod, "tpl_sb_offsets")
    write_frame = ivf_mod.IvfWriter.write_frame
    done = [0]

    def counted_write(self, payload, *args, **kwargs):
        out = write_frame(self, payload, *args, **kwargs)
        done[0] += 1
        if ctx.in_window:
            ctx.complete(1, len(payload))
        elif done[0] == warm and not ctx.window_done:
            ctx.open_window()
        return out

    ctx.patch(ivf_mod.IvfWriter, "write_frame", counted_write)
    tmp = tempfile.mkdtemp(prefix="bench-cli-")
    fifo = os.path.join(tmp, "in.y4m")
    os.mkfifo(fifo)
    stop = threading.Event()
    err = []

    def feed():
        try:
            with open(fifo, "wb") as f:
                f.write(_header(c["width"], c["height"], c["bit_depth"]))
                t = 0
                while not stop.is_set() and not ctx.window_done and \
                        not ctx.window_over():
                    y, u, v = ctx.source.frame(t)
                    f.write(b"FRAME\n")
                    f.write(y.tobytes())
                    f.write(u.tobytes())
                    f.write(v.tobytes())
                    t += 1
        except BrokenPipeError:
            pass                      # the command stopped reading
        except Exception as e:        # reported by the main thread
            err.append(e)

    feeder = threading.Thread(target=feed, name="bench-y4m-feed")
    feeder.start()
    try:
        rc = cli.main(list(c["argv"]) + ["-i", fifo, "-b",
                                         os.path.join(tmp, "out.ivf")])
    finally:
        stop.set()
        # a command that failed before opening the pipe leaves the feeder
        # blocked in open(): open the read end once to release it
        if feeder.is_alive():
            try:
                fd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
                os.close(fd)
            except OSError:
                pass
        feeder.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if err:
        raise err[0]
    if rc != 0:
        raise RuntimeError(f"the command exited with {rc}")
