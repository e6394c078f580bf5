"""setup_s (s, host clock): from the start of the process to the opening
of the window: interpreter and torch start, CUDA context, the first
run's builds (native library, K1), the encoder, and the traffic's
warm-up."""


def read(ctx):
    return ctx.setup_s
