from svt_av1_psy_tpu_torch.app.cli import main

__all__ = ["main"]
