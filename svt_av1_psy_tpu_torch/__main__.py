from svt_av1_psy_tpu_torch.app.cli import main

raise SystemExit(main())
