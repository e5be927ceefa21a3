"""`python -m rovr_torch <cmd> [flags]`: see rovr_torch/cli.py."""

from rovr_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
