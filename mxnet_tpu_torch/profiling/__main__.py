"""``python -m mxnet_tpu_torch.profiling`` == the ``mxprof`` CLI."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
