"""psnr_y_db (dB): the luma PSNR of the frames shown inside the window,
as the reference decoder gives them (checks/stream.py decodes the
stream), against their source, averaged over the frames. The quality
that the bytes of kbytes_per_frame buy."""


def read(ctx):
    return ctx.values.get("psnr_y_db")
