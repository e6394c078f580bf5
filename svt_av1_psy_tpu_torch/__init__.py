"""svt_av1_psy_tpu_torch — the PyTorch/CUDA port of svt_av1_psy_tpu.

The JAX package stays the reference. This package re-does its device
search programs in PyTorch and writes its Pallas kernels again by hand for
NVIDIA Hopper (CUDA C++ under ``csrc/``). Everything else — the native C
commit walks, entropy coding, in-loop filters, bitstream writer and config
schema — is imported unchanged from the shared JAX-free layers of
``svt_av1_psy_tpu``. The package never imports ``jax``.

What it covers today: presets 8-13 with loop restoration off, in low
delay and in random access (temporal filter and TPL on) —

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    enc = Encoder(cfg, 1920, 1080, device="cuda")

Unported branches raise ``NotImplementedError`` naming their ROADMAP item.
"""

__version__ = "0.1.0"
