"""``python -m mxnet_tpu_torch.telemetry`` -> the telemetry CLI."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
