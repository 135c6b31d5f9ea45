"""``python -m mxnet_tpu_torch.analysis`` -> the port's mxlint CLI."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
