"""Console-script shim: pyproject's [project.scripts] names
svt_av1_psy_tpu_torch.app.main:main (svt-av1-psy-torch, the port's
SvtAv1EncApp entry, ref Source/App/app_main.c:494); the implementation
lives in cli.py."""

from svt_av1_psy_tpu_torch.app.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
