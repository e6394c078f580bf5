"""svt_av1_psy_tpu_torch — the PyTorch/CUDA port of svt_av1_psy_tpu.

The JAX package stays the reference. This package stands alone: it
imports neither ``jax`` nor any module of ``svt_av1_psy_tpu``. It carries
its own copy of every host module it runs (the bitstream, entropy,
decoder, inter, numpy ops and config layers, each the reference's file
with only its import prefix changed), builds the repo's C sources in
``native/`` into a library of its own, re-does the device search programs
in PyTorch and writes the Pallas kernels again by hand for NVIDIA Hopper
(CUDA C++ under ``csrc/``).

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    enc = Encoder(cfg, 1920, 1080, device="cuda")

or, from the command line, ``python -m svt_av1_psy_tpu_torch -i in.y4m
-b out.ivf --device cuda``; from C, through the shim that
``capi_build.py`` builds (``libsvtav1_torch.so``, the reference's
``native/capi.h``). Multi-device runs take lists of devices in place of
meshes (``FastIntraEncoder.make_sharded_decide``, ``RaDriver.gop_meshes``;
``graft_entry.dryrun_multichip`` drives both).
"""

__version__ = "0.1.0"
